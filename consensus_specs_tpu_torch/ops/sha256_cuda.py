"""Build, bind and launch the hand-written SHA-256 kernels (csrc/sha256.cu).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface the first time a kernel is launched, and loaded
with ctypes. Nothing is built when the module is imported. The library is
kept under ``build/torch_ext/`` at the root of the checkout, named by the
hash of its source, so an edited source is rebuilt.

Each wrapper takes CUDA tensors only, checks them, launches on PyTorch's
current stream, raises if the launch is refused, and counts the launch in
``launches`` and the message bytes in ``bytes_in``. There is no fallback: a
build or launch failure raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_SOURCE = Path(__file__).resolve().parent / "csrc" / "sha256.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC"]

KERNELS = ("sha256_blocks", "sha256_raw_blocks")
launches = dict.fromkeys(KERNELS, 0)
bytes_in = dict.fromkeys(KERNELS, 0)

_lib = None
_lock = threading.Lock()


def reset_counters() -> None:
    for k in KERNELS:
        launches[k] = 0
        bytes_in[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build csrc/sha256.cu")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(verbose: bool = False) -> Path:
    """Compile csrc/sha256.cu into ``build/torch_ext/`` unless a library of
    the same source is already there. Returns the library's path."""
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libsha256_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name in ("sha256_blocks_launch", "sha256_raw_blocks_launch"):
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.sha256_error_string.argtypes = [ctypes.c_int]
            lib.sha256_error_string.restype = ctypes.c_char_p
            _lib = lib
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
