"""The engine's bulk delta arithmetic on the torch backend (opt-in via
``engine.use_backend("torch")``): K10 ``flag_deltas`` (csrc/flag_deltas.cu)
on the card, its plain PyTorch version on the CPU.

Only the embarrassingly-parallel elementwise piece moves to the device:
the altair flag-weight reward/penalty formula over the whole registry
(altair/beacon-chain.md:367-389). Everything stateful (masks, sums,
sequential churn) stays on host. The columns are uint64. The kernel
computes in true uint64, so callers must have proved the products fit 64
bits before dispatching (engine/stages.py's guard) — like any fixed-width
lane it wraps past them. The plain version computes in int64 (torch has
no uint64 floor division on the CPU), so it is exact only where the
numerator fits 2^63 - 1: ``exact_max`` gives each device's bound, and the
engine's guard reads it.

K10 is built by ``ops.cuda_build`` at its first launch (nothing is built
when this module is imported), bound through ctypes with
``FLAG_DELTAS_ARGTYPES``, and counts each launch in ``launches`` and its
row count in ``sizes``. Its wrapper takes CUDA tensors and raises on
anything else; a build or launch failure raises.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..ops import cuda_build

U64_MAX = 2**64 - 1
I64_MAX = 2**63 - 1
SOURCE = "flag_deltas.cu"

_P, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
# flag_deltas_launch(increments, in_mask, eligible, brpi, weight, upi,
#                    active_increments, wd, leak, penalize, rewards,
#                    penalties, n, stream)
FLAG_DELTAS_ARGTYPES = [_P, _P, _P, _U64, _U64, _U64, _U64, _U64, ctypes.c_int, ctypes.c_int, _P, _P, _I64, _P]
launches = {"flag_deltas": 0}
sizes: dict = {"flag_deltas": {}}  # rows a launch -> launches

_lib = None
_lock = threading.Lock()


def reset_counters() -> None:
    launches["flag_deltas"] = 0
    sizes["flag_deltas"].clear()


def build(verbose: bool = False) -> Path:
    """Compile csrc/flag_deltas.cu unless it is built already; returns the library."""
    return cuda_build.build(SOURCE, verbose=verbose)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = cuda_build.load(SOURCE, (), {"flag_deltas_launch": FLAG_DELTAS_ARGTYPES},
                                   "flag_deltas_error_string")
    return _lib


def exact_max(device) -> int:
    """The largest reward numerator (base * weight * upi) computed exactly
    on ``device``: uint64's on the card, int64's on the CPU."""
    return U64_MAX if torch.device(device).type == "cuda" else I64_MAX


def flag_deltas_cuda(increments: torch.Tensor, in_mask: torch.Tensor, eligible: torch.Tensor,
                     brpi: int, weight: int, upi: int, active_increments: int, wd: int,
                     leak: bool, penalize: bool) -> tuple:
    """K10 on CUDA tensors: ``increments`` (n,) int64 read as uint64 bits,
    the masks (n,) bool; returns (rewards, penalties), (n,) int64 tensors
    holding uint64 bits. One launch."""
    cols = (increments, in_mask, eligible)
    for name, t, dtype in zip(("increments", "in_mask", "eligible"), cols, (torch.int64, torch.bool, torch.bool)):
        if t.device.type != "cuda":
            raise ValueError(f"flag_deltas: {name}: expected a CUDA tensor, got one on {t.device}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"flag_deltas: {name}: expected contiguous (n,) {dtype}, got {t.dtype} {tuple(t.shape)}")
    n = increments.numel()
    if in_mask.numel() != n or eligible.numel() != n or len({t.device for t in cols}) != 1:
        raise ValueError("flag_deltas: columns of different lengths or devices")
    for name, v in (("brpi", brpi), ("weight", weight), ("upi", upi), ("active_increments", active_increments),
                    ("wd", wd)):
        if not 0 <= int(v) <= U64_MAX:
            raise ValueError(f"flag_deltas: {name} = {v} is not a uint64")
    rewards = torch.empty(n, dtype=torch.int64, device=increments.device)
    penalties = torch.empty(n, dtype=torch.int64, device=increments.device)
    if n == 0:
        return rewards, penalties
    lib = _load()
    with torch.cuda.device(increments.device):
        rc = lib.flag_deltas_launch(increments.data_ptr(), in_mask.data_ptr(), eligible.data_ptr(), int(brpi),
                                    int(weight), int(upi), int(active_increments), int(wd), int(bool(leak)),
                                    int(bool(penalize)), rewards.data_ptr(), penalties.data_ptr(), n,
                                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flag_deltas launch failed: {lib.error_string(rc).decode()}")
    launches["flag_deltas"] += 1
    sizes["flag_deltas"][n] = sizes["flag_deltas"].get(n, 0) + 1
    return rewards, penalties


def flag_deltas_plain(increments: torch.Tensor, in_mask: torch.Tensor, eligible: torch.Tensor,
                      brpi: int, weight: int, upi: int, active_increments: int, wd: int,
                      leak: bool, penalize: bool) -> tuple:
    """K10's plain version, on int64 tensors of any device: exact where
    increments * brpi * weight * max(upi, 1) <= 2^63 - 1."""
    base = increments * brpi
    zero = torch.zeros_like(base)
    rewards = zero if leak else torch.where(in_mask & eligible, base * weight * upi // (active_increments * wd), zero)
    penalties = torch.where(~in_mask & eligible, base * weight // wd, zero) if penalize else zero.clone()
    return rewards, penalties


def _tensor(column: np.ndarray, dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(column, dtype=dtype)
    return torch.from_numpy(a.view(np.int64) if dtype is np.uint64 else a).to(device)


def flag_deltas(increments: np.ndarray, in_mask: np.ndarray, eligible: np.ndarray,
                brpi: int, weight: int, upi: int, active_increments: int,
                wd: int, leak: bool, penalize: bool, device=None):
    """One flag's (rewards, penalties) uint64 columns for numpy columns in,
    as ``ops_jax.flag_deltas`` gives them: K10 on the card (``device``
    None: the CUDA card, raising without one), with the columns copied to
    it and back; the plain version on the CPU, which raises where it would
    not be exact. Any other device raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        hi = int(increments.max()) if increments.size else 0
        if hi * brpi * weight * max(upi, 1) > I64_MAX:
            raise ValueError("flag_deltas: the reward numerator exceeds the plain version's int64 range")
    elif dev.type != "cuda":
        raise ValueError(f"flag_deltas: no kernel for device {dev}")
    args = (_tensor(increments, np.uint64, dev), _tensor(in_mask, bool, dev), _tensor(eligible, bool, dev),
            brpi, weight, upi, active_increments, wd, leak, penalize)
    rewards, penalties = (flag_deltas_cuda if dev.type == "cuda" else flag_deltas_plain)(*args)
    return rewards.cpu().numpy().view(np.uint64), penalties.cpu().numpy().view(np.uint64)
