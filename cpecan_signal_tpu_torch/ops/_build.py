"""Build and bind the CUDA kernels of ``csrc/``.

At first use ``nvcc`` compiles every ``csrc/*.cu`` source into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), written to ``build/torch_kernels/`` at the repository root under a
name keyed by a hash of the sources and flags; ctypes loads it.  A library
whose key matches is reused.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of csrc/fb_sm3.cu: (argtypes, restype); every launcher ends
# with (device index, stream) and returns cudaGetLastError()
_SIGNATURES = {
    "fb_error_string": ([_I], ctypes.c_char_p),
    "fb_emissions_sm3": ([_P] * 5 + [_I] * 7 + [_I, _P], _I),
    "fb_forward": ([_P] * 7 + [_I] * 9 + [_I, _P], _I),
    # ..., ds_rows, the state mask of the posterior channels
    "fb_backward_sm3": ([_P] * 9 + [_I] * 10 + [_I, _P], _I),
    # + exits, gacc, stats; ..., ds_rows, match state, G, the MAX_G group bitmasks
    "fb_backward_sm3_em": ([_P] * 12 + [_I] * 15 + [_I, _P], _I),
    # + exits, gacc, stats; ..., ds_rows, G, the MAX_G group bitmasks, the
    # channel count, a host array of its 64-bit edge-group masks
    "fb_backward_sm3_pgroups": ([_P] * 12 + [_I] * 15 + [_P] + [_I, _P], _I),
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfb_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def bind(path: Path, names=None) -> ctypes.CDLL:
    """Load a kernel library and declare the C types of its entry points
    ``names`` (default: all of them)."""
    lib = ctypes.CDLL(str(path))
    for name in _SIGNATURES if names is None else names:
        argtypes, restype = _SIGNATURES[name]
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed and bind."""
    return bind(build())
