"""Build and load the port's CUDA sources (``ops/csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface the first time one of its kernels is launched,
and loaded with ctypes. Nothing is built when a module is imported. The
libraries are kept under ``build/torch_ext/`` at the root of the checkout,
named by the hash of the source, the headers it includes and the flags, so
an edited source is rebuilt. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(source: str, headers: Sequence[str] = (), verbose: bool = False) -> Path:
    """Compile ``csrc/<source>`` into ``build/torch_ext/`` unless a library
    of the same source, headers and flags is already there. Returns the
    library's path; with ``verbose`` prints ptxas's register report."""
    src = CSRC / source
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for name in headers:
        h.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source} failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, lib)
    return lib


def load(source: str, headers: Sequence[str], signatures: dict, error_fn: str) -> ctypes.CDLL:
    """Build (if needed) and load ``source``; ``signatures`` maps each C
    function to its ctypes argument types (all return int, a cudaError_t);
    ``error_fn`` is the library's error-string function, also bound as
    ``lib.error_string``."""
    lib = ctypes.CDLL(str(build(source, headers)))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = getattr(lib, error_fn)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    return lib
