"""Engine compute-backend hook — the ops/ convention applied to the
protocol plane.

The NumPy host path is always available and always correct; the torch
path is OPT-IN, exactly like ``bls.use_backend("torch")`` and
``use_device_hasher()`` on the crypto plane. Stages route their bulk
elementwise delta arithmetic through :func:`delta_kernel` when the torch
backend is active AND the row count clears ``DEVICE_MIN_ROWS`` (a
dispatch costs its copies to and from the card; small registries never
win) AND the stage's own overflow guard proved the products lie in the
kernel's exact range, :func:`exact_max` (the kernel wraps silently where
NumPy's guarded helpers would fall back to exact object ints — so the
guard decides the dispatch, not the kernel).

There is no supervision and no fallback: a failed build or launch
raises. ``use_backend("torch")`` runs on the CUDA card and raises without
one; ``device="cpu"`` asks for the kernel's plain PyTorch version.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

from .. import resolve_device

_active = "numpy"
_device = None

DEVICE_MIN_ROWS = 4096  # below this, dispatch overhead beats the kernel


def use_backend(name: str = "numpy", device=None) -> str:
    """Select the engine compute backend: ``numpy`` (host, default) or
    ``torch`` (K10 on the card; ``device="cpu"``: its plain version).
    Returns the backend installed."""
    global _active, _device
    if name not in ("numpy", "torch"):
        raise ValueError(f"unknown engine backend {name!r} (have numpy, torch)")
    if name == "torch":
        dev = resolve_device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"engine backend torch: no kernel for device {dev}")
        _device = dev
    else:
        _device = None
    _active = name
    return _active


def active() -> str:
    return _active


def delta_kernel() -> Optional[Callable]:
    """``ops_torch.flag_deltas`` on the backend's device when the torch
    backend is active, else None (callers take the NumPy path)."""
    if _active != "torch":
        return None
    from . import ops_torch

    return functools.partial(ops_torch.flag_deltas, device=_device)


def exact_max() -> int:
    """The largest reward numerator the active kernel computes exactly."""
    from . import ops_torch

    return ops_torch.exact_max(_device)
