"""Checkpoint / resume for EM training state.

The reference's checkpointing is plain text files rewritten every EM iteration
(SURVEY §5: merged HMM files via trainModels.py:126-135, HDP serialization
overwritten in place).  Those text formats are kept (em/accumulators.py,
hdp/nanopore.py); this module adds the TPU-native equivalent — an atomic
checkpoint of the full training state (emission tables, transition vectors, EM
accumulators, RNG key, iteration counter) with orbax when available, npz
otherwise.

Copied from ``cpecan_signal_tpu/utils/checkpoint.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def save_checkpoint(path: str, state: dict, step: int) -> None:
    """Atomically write a training-state pytree of numpy arrays + scalars."""
    arrays = {}
    meta = {"step": step, "keys": {}}

    def flatten(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                flatten(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(obj, (list, tuple)):
            meta["keys"][prefix] = {"type": "list", "n": len(obj)}
            for i, v in enumerate(obj):
                flatten(f"{prefix}[{i}]", v)
        elif np.isscalar(obj) or obj is None:
            meta["keys"][prefix] = {"type": "scalar", "value": obj}
        else:
            arrays[prefix] = np.asarray(obj)
            meta["keys"][prefix] = {"type": "array"}

    flatten("", state)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".ckpt.tmp")
    os.close(fd)
    np.savez_compressed(tmp, __meta__=json.dumps(meta), **arrays)
    # np.savez appends .npz
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    if os.path.exists(tmp):
        os.unlink(tmp)


def load_checkpoint(path: str) -> tuple[dict, int]:
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        out: dict = {}

        def assign(key, value):
            parts = key.replace("]", "").replace("[", ".").split(".")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value

        for key, info in meta["keys"].items():
            if info["type"] == "scalar":
                assign(key, info["value"])
            elif info["type"] == "array":
                assign(key, data[key])
    return out, meta["step"]


def latest_checkpoint(directory: str, prefix: str = "ckpt") -> str | None:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".npz"):
            best = max(best or "", os.path.join(directory, name))
    return best
