"""Bind and launch the hand-written Fr kernels of ``csrc/fr_fft.cu``: K12
``fr_mul`` (the pointwise Montgomery product a b 2^-264 mod r, and the
butterfly's sums as op codes 1 and 2) and K11 ``fr_fft`` (the radix-2 DIT,
one launch a stage).

The source (with its device header ``csrc/fr.cuh``) is built at first
launch by ``cuda_build``; nothing is built when the module is imported.

The wrappers take CUDA int32 tensors of canonical limbs ``(..., 22)`` in
Montgomery form (radix 2^264, ``fr_plain``'s layout), launch on PyTorch's
current stream, raise if a launch is refused, and count in ``launches``
and ``sizes`` (elements a launch -> launches), one a kernel launch:
K11 adds log2 n a transform, the stage launches its C launcher makes.
There is no fallback: a build or launch failure raises.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from . import cuda_build, fr_plain
from .fq_cuda import _broadcast_shape

N_LIMBS = fr_plain.N_LIMBS
N_WORDS = 8
KERNELS = ("fr_fft", "fr_mul")
launches = dict.fromkeys(KERNELS, 0)
sizes: dict = {k: {} for k in KERNELS}

OP_MUL, OP_ADD, OP_SUB = 0, 1, 2

_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SCALE = ctypes.c_uint32 * N_WORDS
# the ctypes argument types of fr_fft.cu's C launch functions
MUL_ARGTYPES = [_P, _I64, _P, _I64, _P, _I64, ctypes.c_int, _P]
FFT_ARGTYPES = [_P, _P, _P, _P, _I64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, _P]
WORD_R = 1 << (32 * N_WORDS)  # the kernels' internal Montgomery radix 2^256

_twiddles: dict = {}  # (n, inverse, device) -> (n/2, 8) int32 words on the device
_scales: dict = {}  # n -> n^-1 2^256 mod r as 8 words


def reset_counters() -> None:
    for k in launches:
        launches[k] = 0
        sizes[k].clear()


def build(verbose: bool = False) -> Path:
    """Compile csrc/fr_fft.cu unless it is built already; returns the library."""
    return cuda_build.build("fr_fft.cu", ("fr.cuh",), verbose=verbose)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = cuda_build.load("fr_fft.cu", ("fr.cuh",),
                                   {"fr_mul_launch": MUL_ARGTYPES, "fr_fft_launch": FFT_ARGTYPES},
                                   "fr_error_string")
    return _lib


def words_of(values) -> np.ndarray:
    """ints below 2^256 -> (len, 8) int32 little-endian words."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype=np.int32).reshape(len(values), N_WORDS).copy()


def twiddle_words(n: int, inverse: bool) -> np.ndarray:
    """K11's twiddles: w^k 2^256 mod r for k < n/2, (n/2, 8) words."""
    p = fr_plain.P_INT
    return words_of([w * WORD_R % p for w in fr_plain.twiddle_ints(n, inverse)])


def _check(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.int32 or x.dim() == 0 or x.shape[-1] != N_LIMBS:
        raise ValueError(f"{name}: expected int32 (..., {N_LIMBS}), got {x.dtype} {tuple(x.shape)}")


def _operand(name: str, x: torch.Tensor, shape: tuple) -> tuple:
    """(tensor, stride in int32 elements) as K12 reads it: one element for
    the whole batch is read with stride 0."""
    _check(name, x)
    if x.numel() == N_LIMBS:
        return x.reshape(N_LIMBS).contiguous(), 0
    return x.expand(shape).contiguous(), N_LIMBS


def fr_mul(a: torch.Tensor, b: torch.Tensor, op: int = OP_MUL) -> torch.Tensor:
    """K12: a b 2^-264 (op 0), a + b (op 1) or a - b (op 2) mod r,
    broadcast over the leading dimensions."""
    if op not in (OP_MUL, OP_ADD, OP_SUB):
        raise ValueError(f"fr_mul: unknown op {op}")
    shape = _broadcast_shape(a.shape, b.shape)
    (x, xs), (y, ys) = _operand("fr_mul", a, shape), _operand("fr_mul", b, shape)
    if x.device != y.device:
        raise ValueError(f"fr_mul: operands on {x.device} and {y.device}")
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    n = out.numel() // N_LIMBS
    if n == 0:
        return out
    lib = _load()
    with torch.cuda.device(x.device):
        rc = lib.fr_mul_launch(x.data_ptr(), xs, y.data_ptr(), ys, out.data_ptr(), n, op,
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fr_mul launch failed: {lib.error_string(rc).decode()}")
    launches["fr_mul"] += 1
    sizes["fr_mul"][n] = sizes["fr_mul"].get(n, 0) + 1
    return out


def fr_fft(vals: torch.Tensor, n: int, inverse: bool = False) -> torch.Tensor:
    """K11: the radix-2 DIT of ``vals`` (n, 22) in Montgomery form, n a
    power of two >= 2; on the inverse, scaled by n^-1. log2 n launches."""
    _check("fr_fft", vals)
    if n < 2 or n & (n - 1) or tuple(vals.shape) != (n, N_LIMBS):
        raise ValueError(f"fr_fft: expected (n, {N_LIMBS}) for a power of two n >= 2, got n={n} "
                         f"and {tuple(vals.shape)}")
    dev = vals.device
    key = (n, bool(inverse), str(dev))
    tw = _twiddles.get(key)
    if tw is None:
        tw = _twiddles[key] = torch.from_numpy(twiddle_words(n, bool(inverse))).to(dev)
    scale = _scales.get(n)
    if scale is None:
        p = fr_plain.P_INT
        scale = _scales[n] = _SCALE(*(int(w) & 0xFFFFFFFF for w in words_of([pow(n, p - 2, p) * WORD_R % p])[0]))
    x = vals.contiguous()
    words = torch.empty((n, N_WORDS), dtype=torch.int32, device=dev)
    out = torch.empty((n, N_LIMBS), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.fr_fft_launch(x.data_ptr(), words.data_ptr(), out.data_ptr(), tw.data_ptr(), n,
                               n.bit_length() - 1, scale, int(bool(inverse)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fr_fft launch failed: {lib.error_string(rc).decode()}")
    stages = n.bit_length() - 1
    launches["fr_fft"] += stages
    sizes["fr_fft"][n] = sizes["fr_fft"].get(n, 0) + stages
    return out
