"""Bind and launch the hand-written SHA-256 kernels (csrc/sha256.cu).

The source is built at first launch by ``cuda_build`` (nvcc for
``sm_90a``, a plain C interface loaded with ctypes, kept under
``build/torch_ext/``); nothing is built when the module is imported.

Each wrapper takes CUDA tensors only, checks them, launches on PyTorch's
current stream, raises if the launch is refused, and counts the launch in
``launches`` and the message bytes in ``bytes_in``. There is no fallback: a
build or launch failure raises.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from . import cuda_build

KERNELS = ("sha256_blocks", "sha256_raw_blocks")
launches = dict.fromkeys(KERNELS, 0)
bytes_in = dict.fromkeys(KERNELS, 0)

_lib = None
_lock = threading.Lock()


def reset_counters() -> None:
    for k in KERNELS:
        launches[k] = 0
        bytes_in[k] = 0


def build(verbose: bool = False) -> Path:
    """Compile csrc/sha256.cu unless it is built already; returns the library."""
    return cuda_build.build("sha256.cu", verbose=verbose)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            _lib = cuda_build.load("sha256.cu", (), {f"{k}_launch": args for k in KERNELS},
                                   "sha256_error_string")
    return _lib


def _launch(name: str, blocks: torch.Tensor) -> torch.Tensor:
    if blocks.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {blocks.device}")
    if blocks.dtype != torch.int32 or blocks.dim() != 2 or blocks.shape[1] != 16:
        raise ValueError(f"{name}: expected int32 (N, 16), got {blocks.dtype} {tuple(blocks.shape)}")
    if not blocks.is_contiguous() or blocks.data_ptr() % 16:
        raise ValueError(f"{name}: input must be contiguous and 16-byte aligned")
    n = blocks.shape[0]
    out = torch.empty((n, 8), dtype=torch.int32, device=blocks.device)
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"{name}_launch")(blocks.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.sha256_error_string(rc).decode()}")
    launches[name] += 1
    bytes_in[name] += 64 * n
    return out


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """K1: (N, 16) int32 message bytes on the card -> (N, 8) digest bytes."""
    return _launch("sha256_blocks", blocks)


def sha256_raw_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """K2: one compression from the IV over (N, 16) host-padded blocks."""
    return _launch("sha256_raw_blocks", blocks)
