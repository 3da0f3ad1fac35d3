"""Device selection for the port's entry points (the utils/platform.py
analogue).

The device is resolved once, at the entry point, and passed down explicitly;
nothing below the entry points reads global device state.  The card is the
default: the CPU runs only when the caller asks for it
(``SIGALIGN_PLATFORM=cpu`` or ``resolve_device("cpu")``).  ``cuda`` on a
machine without a usable card raises: the port never moves work to the CPU
behind the caller's back.
"""

from __future__ import annotations

import os

import torch


def resolve_device(name: str | None = None) -> torch.device:
    """``name`` (default: $SIGALIGN_PLATFORM, else ``cuda``) -> torch.device.
    Accepts ``cpu``, ``cuda`` and ``cuda:<index>``."""
    name = name or os.environ.get("SIGALIGN_PLATFORM") or "cuda"
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda" or name.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but torch reports "
                               "no usable CUDA device (set SIGALIGN_PLATFORM=cpu "
                               "to run the plain versions on the CPU)")
        return torch.device(name)
    raise ValueError(f"unsupported platform {name!r} (expected cpu or cuda)")
