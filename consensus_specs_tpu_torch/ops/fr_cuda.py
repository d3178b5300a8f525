"""Bind and launch the hand-written Fr kernels of ``csrc/fr_fft.cu``: K12
``fr_mul`` (the pointwise Montgomery product a b 2^-264 mod r, and the
butterfly's sums as op codes 1 and 2, a block a tile of 128 elements) and
K11 ``fr_fft`` (the radix-2 DIT, one launch a pass of up to
``FFT_PASS_STAGES`` stages run in shared memory).

The source (with its device header ``csrc/fr.cuh``) is built at first
launch by ``cuda_build``; nothing is built when the module is imported.

The wrappers take CUDA int32 tensors of canonical limbs ``(..., 22)`` in
Montgomery form (radix 2^264, ``fr_plain``'s layout), launch on PyTorch's
current stream, raise if a launch is refused, and count in ``launches``
and ``sizes`` (elements a launch -> launches), one a kernel launch:
K11 adds ``fft_passes(n)`` a transform, the pass launches its C launcher
makes. The kernels take 8-byte aligned limb rows: an operand that is not
(a view at an odd offset) is copied first. K12 copies its tiles in
16-byte pieces where all its tensors are 16-byte aligned, else in 8-byte
pieces (its launcher chooses).
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
FFT_PASS_STAGES = 8  # fr.cuh kPassStages: the most stages a K11 launch runs

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


def fft_plan(n: int) -> list:
    """K11's passes for a transform of n = 2^k rows, as fr.cuh pass_plan
    launches them: (first stage, stages) each, ceil(k / FFT_PASS_STAGES)
    passes of as equal a size as can be, the last the shortest."""
    k = n.bit_length() - 1
    passes = -(-k // FFT_PASS_STAGES)
    per = -(-k // passes)
    return [(s0, min(per, k - s0)) for s0 in range(0, k, per)]


def fft_passes(n: int) -> int:
    """K11's launches for a transform of n rows: one a pass."""
    return len(fft_plan(n))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    return x if x.data_ptr() % 8 == 0 else x.clone()


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
        return _aligned(x.reshape(N_LIMBS).contiguous()), 0
    return _aligned(x.expand(shape).contiguous()), N_LIMBS


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


def fft_constants(n: int, inverse: bool, device) -> tuple:
    """K11's constants for a transform of n on ``device``, cached: the
    twiddle words ((n/2, 8) int32) and n^-1 2^256 mod r (8 words, a ctypes
    array)."""
    key = (n, bool(inverse), str(device))
    tw = _twiddles.get(key)
    if tw is None:
        tw = _twiddles[key] = torch.from_numpy(twiddle_words(n, bool(inverse))).to(device)
    scale = _scales.get(n)
    if scale is None:
        p = fr_plain.P_INT
        scale = _scales[n] = _SCALE(*(int(w) & 0xFFFFFFFF for w in words_of([pow(n, p - 2, p) * WORD_R % p])[0]))
    return tw, scale


def fr_fft(vals: torch.Tensor, n: int, inverse: bool = False) -> torch.Tensor:
    """K11: the radix-2 DIT of ``vals`` (n, 22) in Montgomery form, n a
    power of two >= 2; on the inverse, scaled by n^-1. ``fft_passes(n)``
    launches."""
    _check("fr_fft", vals)
    if n < 2 or n & (n - 1) or tuple(vals.shape) != (n, N_LIMBS):
        raise ValueError(f"fr_fft: expected (n, {N_LIMBS}) for a power of two n >= 2, got n={n} "
                         f"and {tuple(vals.shape)}")
    dev = vals.device
    tw, scale = fft_constants(n, inverse, dev)
    x = _aligned(vals.contiguous())
    words = torch.empty((n, N_WORDS), dtype=torch.int32, device=dev)
    out = torch.empty((n, N_LIMBS), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.fr_fft_launch(x.data_ptr(), words.data_ptr(), out.data_ptr(), tw.data_ptr(), n,
                               n.bit_length() - 1, scale, int(bool(inverse)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fr_fft launch failed: {lib.error_string(rc).decode()}")
    passes = fft_passes(n)
    launches["fr_fft"] += passes
    sizes["fr_fft"][n] = sizes["fr_fft"].get(n, 0) + passes
    return out
