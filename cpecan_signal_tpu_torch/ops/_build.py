"""Build the native sources of ``csrc/`` and bind the CUDA kernels.

At first use ``nvcc`` compiles every ``csrc/*.cu`` source into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), written to ``build/torch_kernels/`` at the repository root under a
name keyed by a hash of the sources and flags; ctypes loads it.  The host
sources (``csrc/*.cpp``) are built one library each by ``g++``
(``host_library``), keyed by the source, the flags and the host CPU.  A
library whose key matches is reused.  A missing compiler or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
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
# with (device index, stream) and returns cudaGetLastError(); the backward
# ones take a workspace (fb_kernels.backward_work_floats) before them
_SIGNATURES = {
    "fb_error_string": ([_I], ctypes.c_char_p),
    "fb_emissions_sm3": ([_P] * 5 + [_I] * 7 + [_I, _P], _I),
    # ..., F, offF (f64), then the sizes
    "fb_forward": ([_P] * 8 + [_I] * 9 + [_I, _P], _I),
    # E, F, offF, ...; ..., ds_rows, the state mask of the posterior
    # channels, the workspace
    "fb_backward_sm3": ([_P] * 10 + [_I] * 10 + [_P] + [_I, _P], _I),
    # + exits, gacc, stats; ..., ds_rows, match state, G, the MAX_G group
    # bitmasks, the workspace
    "fb_backward_sm3_em": ([_P] * 13 + [_I] * 15 + [_P] + [_I, _P], _I),
    # + exits, gacc, stats; ..., ds_rows, G, the MAX_G group bitmasks, the
    # channel count, a host array of its 64-bit edge-group masks, the workspace
    "fb_backward_sm3_pgroups": ([_P] * 13 + [_I] * 15 + [_P, _P] + [_I, _P], _I),
    # (S, C, W, n_edges, stage 4?) -> 4 ints: ring slots, recursion shared
    # bytes, epilogue warps, epilogue shared bytes
    "fb_launch_config": ([_I] * 5 + [_P], None),
    # (S, C, W, backward?, device) -> the recursion blocks an SM holds
    "fb_recursion_blocks_per_sm": ([_I] * 5 + [_P], _I),
    # W -> 4 ints: diagonals a block, floats of a staged row, threads and
    # dynamic shared bytes of an emissions block
    "fb_emissions_config": ([_I, _P], None),
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


def _compile(cmd: list[str], out: Path) -> Path:
    """Run ``cmd`` with ``-o <temporary>`` appended and move the result to
    ``out``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*cmd, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    sources = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    return _compile([_nvcc(), *NVCC_FLAGS, *sources], out)


def _cpu_key() -> str:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = [ln for ln in fh if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.machine() + platform.processor()


def host_library_path(name: str, flags: tuple[str, ...]) -> Path:
    """Path of the library of ``csrc/<name>`` for these flags and this CPU
    (a library built with -march=native runs only on the CPU it was built
    for)."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update((CSRC / name).read_bytes())
    h.update(_cpu_key().encode())
    return BUILD_DIR / f"lib{Path(name).stem}_{h.hexdigest()[:16]}.so"


def host_library(name: str, flags: tuple[str, ...]) -> Path:
    """Compile ``csrc/<name>`` with g++ and ``flags`` unless a library for
    this source, these flags and this CPU exists."""
    out = host_library_path(name, flags)
    if out.exists():
        return out
    return _compile(["g++", *flags, str(CSRC / name)], out)


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
