"""Liveness probe for the card: does a hand-written kernel build, load and
run here?

The port of the JAX package's Pallas probe kernel (``tools/pallas_probe.py``
``kern``: ``x + 1`` on an (8, 128) int32 array, which told whether Mosaic
compiled). Here the kernel is ``csrc/probe.cu`` (``add_one``), built with
nvcc for sm_90a at first use, and ``probe()`` holds it against its plain
version on the same (8, 128) input.

    python -m consensus_specs_tpu_torch.probe
"""
from __future__ import annotations

import ctypes
import json
import threading
import time

import torch

from . import resolve_device
from .ops import cuda_build

launches = {"add_one": 0}

_lib = None
_lock = threading.Lock()


def reset_counters() -> None:
    launches["add_one"] = 0


def build(verbose: bool = False):
    return cuda_build.build("probe.cu", verbose=verbose)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            _lib = cuda_build.load("probe.cu", (), {"add_one_launch": args}, "probe_error_string")
    return _lib


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version."""
    return x + 1


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 over an int32 tensor: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return add_one_plain(x)
    if x.device.type != "cuda" or x.dtype != torch.int32:
        raise ValueError(f"add_one: expected int32 on the card, got {x.dtype} on {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(x.device):
        rc = lib.add_one_launch(x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"add_one launch failed: {lib.probe_error_string(rc).decode()}")
    launches["add_one"] += 1
    return out


def probe(device=None) -> dict:
    """Build and run the kernel on (8, 128) int32 zeros; raises unless every
    element reads 1 and equals the plain version."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    x = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    got = add_one(x)
    want = add_one_plain(x)
    if not (torch.equal(got, want) and bool((got == 1).all())):
        raise AssertionError("add_one disagrees with its plain version")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"device": str(dev), "ok": True, "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    print(json.dumps(probe()))
