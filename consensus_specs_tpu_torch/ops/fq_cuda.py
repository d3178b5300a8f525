"""Bind and launch the hand-written BLS12-381 kernels, each a lane-group
kernel (a group of lanes of a warp per element): K3 ``fq_mul`` and K4
``fq_addsub`` (csrc/fq.cu), the static-exponent pow chains K5 ``fq_pow``
(Fq) and K6 ``fq2_pow`` (Fq2), one launch a chain (csrc/fq_pow.cu), the
static scalar ladders K7 ``g1_mul_static`` and K8 ``g2_mul_static``, one
launch a ladder (csrc/curve.cu), and the inversion K9 ``fq_inv`` by binary
GCD, one thread an element (csrc/fq_inv.cu).

Each source (with its device headers ``csrc/fq.cuh``, ``csrc/curve.cuh``)
is built at first launch by ``cuda_build``; nothing is built when the
module is imported.

Each wrapper takes CUDA int32 tensors of canonical limbs ``(..., 32)``,
broadcasts them, launches on PyTorch's current stream, raises if the
launch is refused, and counts the launch in ``launches`` and its element
count in ``sizes``. An operand that is one element for the whole batch (a
curve or tower constant) is read with stride 0, not materialised. There is
no fallback: a build or launch failure raises. K5/K6 take one operand of
any shape ``(..., 32)`` or ``(..., 2, 32)`` and the exponent as its bits
from the most significant; each bit list is packed into words once and
kept. K9 takes one operand of any shape ``(..., 32)``. K7/K8 take a
Jacobian point ``(X, Y, Z)`` of such tensors (the three broadcast to one
shape) and the scalar as a Python int.

For measurement only, ``fq_mul_thread``/``fq_addsub_thread`` launch the
one-thread kernels of the first port; nothing on the main path calls
them, and each counts under its own name.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from . import cuda_build, fq_plain

N_LIMBS = 32
KERNELS = ("fq_mul", "fq_addsub", "fq_pow", "fq2_pow", "g1_mul_static", "g2_mul_static",
           "fq_inv")  # the main path's
MEASURED = ("fq_mul_thread", "fq_addsub_thread")
launches = dict.fromkeys(KERNELS + MEASURED, 0)
sizes: dict = {k: {} for k in KERNELS + MEASURED}  # elements a launch -> launches

_lib = None
_pow_lib = None
_curve_lib = None
_inv_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_WORDS = ctypes.c_uint32 * 12  # an exponent of at most 384 bits
_exponents: dict = {}  # bits (a tuple) -> (words, length)
_CURVE_HEADERS = ("fq.cuh", "curve.cuh")
# the ctypes argument types of fq_pow.cu's and curve.cu's C launch functions
POW_ARGTYPES = [_P, _P, _I64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, _P]
CURVE_ARGTYPES = [_P] * 6 + [_I64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, _P]
INV_ARGTYPES = [_P, _P, _I64, ctypes.POINTER(ctypes.c_int32), _P]

# K9's start value of the GCD's coefficient e, s = R^2 mod p in 13 signed
# 30-bit limbs (fq.cuh InvStart). The GCD on x = a R gives d = s / x, so
# s = 1 would give (a R)^-1, to be corrected by one Montgomery product by
# C = R^3 mod p (C / R = R^2); s = C / R makes that product at the start.
_R, _PP = fq_plain.R_INT, fq_plain.P_INT
INV_C = pow(_R, 3, _PP)
INV_START_INT = INV_C * pow(_R, -1, _PP) % _PP
INV_START = (ctypes.c_int32 * 13)(*((INV_START_INT >> (30 * j)) & (0x3FFFFFFF if j < 12 else -1) for j in range(13)))
assert INV_START_INT == _R * _R % _PP and sum(v << (30 * j) for j, v in enumerate(INV_START)) == INV_START_INT


def reset_counters() -> None:
    for k in launches:
        launches[k] = 0
        sizes[k].clear()


def build(verbose: bool = False) -> Path:
    """Compile csrc/fq.cu unless it is built already; returns the library."""
    return cuda_build.build("fq.cu", ("fq.cuh",), verbose=verbose)


def build_pow(verbose: bool = False) -> Path:
    """Compile csrc/fq_pow.cu unless it is built already; returns the library."""
    return cuda_build.build("fq_pow.cu", ("fq.cuh",), verbose=verbose)


def build_curve(verbose: bool = False) -> Path:
    """Compile csrc/curve.cu unless it is built already; returns the library."""
    return cuda_build.build("curve.cu", _CURVE_HEADERS, verbose=verbose)


def build_inv(verbose: bool = False) -> Path:
    """Compile csrc/fq_inv.cu unless it is built already; returns the library."""
    return cuda_build.build("fq_inv.cu", ("fq.cuh",), verbose=verbose)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = cuda_build.load("fq.cu", ("fq.cuh",), {
                "fq_mul_launch": [_P, _I64, _P, _I64, _P, _I64, _P],
                "fq_addsub_launch": [_P, _I64, _P, _I64, _P, _I64, ctypes.c_int, _P],
                "fq_mul_thread_launch": [_P, _I64, _P, _I64, _P, _I64, _P],
                "fq_addsub_thread_launch": [_P, _I64, _P, _I64, _P, _I64, ctypes.c_int, _P],
            }, "fq_error_string")
    return _lib


def _load_pow():
    global _pow_lib
    with _lock:
        if _pow_lib is None:
            _pow_lib = cuda_build.load("fq_pow.cu", ("fq.cuh",),
                                       {"fq_pow_launch": POW_ARGTYPES, "fq2_pow_launch": POW_ARGTYPES},
                                       "fq_pow_error_string")
    return _pow_lib


def _load_curve():
    global _curve_lib
    with _lock:
        if _curve_lib is None:
            _curve_lib = cuda_build.load("curve.cu", _CURVE_HEADERS,
                                         {"g1_mul_static_launch": CURVE_ARGTYPES,
                                          "g2_mul_static_launch": CURVE_ARGTYPES},
                                         "curve_error_string")
    return _curve_lib


def _load_inv():
    global _inv_lib
    with _lock:
        if _inv_lib is None:
            _inv_lib = cuda_build.load("fq_inv.cu", ("fq.cuh",), {"fq_inv_launch": INV_ARGTYPES},
                                       "fq_inv_error_string")
    return _inv_lib


def _broadcast_shape(a: torch.Size, b: torch.Size) -> tuple:
    """numpy broadcasting of two shapes (torch.broadcast_shapes costs about
    a hundred microseconds a call, more than a launch)."""
    if a == b:
        return tuple(a)
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)
    out = []
    for x, y in zip(a, b):
        if x != y and 1 not in (x, y):
            raise ValueError(f"shapes {a} and {b} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


def _operand(name: str, x: torch.Tensor, shape: tuple) -> tuple:
    """(tensor, stride in int32 elements) as the kernel reads it."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.int32 or x.dim() == 0 or x.shape[-1] != N_LIMBS:
        raise ValueError(f"{name}: expected int32 (..., {N_LIMBS}), got {x.dtype} {tuple(x.shape)}")
    if x.numel() == N_LIMBS:
        x, stride = x.reshape(N_LIMBS), 0
    else:
        x, stride = x.expand(shape).contiguous(), N_LIMBS
    if x.data_ptr() % 16:
        x = x.clone()
    return x, stride


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, *extra) -> torch.Tensor:
    shape = _broadcast_shape(a.shape, b.shape)
    (x, xs), (y, ys) = _operand(name, a, shape), _operand(name, b, shape)
    if x.device != y.device:
        raise ValueError(f"{name}: operands on {x.device} and {y.device}")
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    n = out.numel() // N_LIMBS
    if n == 0:
        return out
    lib = _load()
    fn = getattr(lib, f"{name}_launch")
    if x.device.index == torch.cuda.current_device():
        rc = fn(x.data_ptr(), xs, y.data_ptr(), ys, out.data_ptr(), n, *extra,
                torch.cuda.current_stream(x.device).cuda_stream)
    else:  # the launch goes to the runtime's current device: switch to the operands'
        with torch.cuda.device(x.device):
            rc = fn(x.data_ptr(), xs, y.data_ptr(), ys, out.data_ptr(), n, *extra,
                    torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.fq_error_string(rc).decode()}")
    launches[name] += 1
    sizes[name][n] = sizes[name].get(n, 0) + 1
    return out


def fq_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3: the Montgomery product a b / 2^384 mod p of canonical limbs."""
    return _launch("fq_mul", a, b)


def fq_addsub(a: torch.Tensor, b: torch.Tensor, op: int) -> torch.Tensor:
    """K4: (a + b), (a - b) or (-b) mod p for op 0, 1, 2 (``fq_plain.OP_*``)."""
    _check_op("fq_addsub", op)
    return _launch("fq_addsub", a, b, op)


def _exponent(bits) -> tuple:
    """MSB-first bits -> (12 little-endian 32-bit words, bit length), made
    once for each bit list."""
    key = tuple(bits)
    hit = _exponents.get(key)
    if hit is None:
        if len(key) > 384 or any(b not in (0, 1) for b in key):
            raise ValueError(f"pow: expected at most 384 bits of 0 or 1, got {len(key)}")
        e = 0
        for b in key:
            e = 2 * e + int(b)
        hit = _exponents[key] = (_WORDS(*((e >> (32 * j)) & 0xFFFFFFFF for j in range(12))), len(key))
    return hit


def _elementwise(name: str, a: torch.Tensor, degree: int, load, *extra) -> torch.Tensor:
    """Launch ``<name>_launch(a, out, n, *extra, stream)`` of the library
    ``load()`` on one operand of Fq (degree 1) or Fq2 elements of any
    shape; returns ``out``."""
    tail = (N_LIMBS,) if degree == 1 else (2, N_LIMBS)
    if a.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {a.device}")
    if a.dtype != torch.int32 or tuple(a.shape[-degree:]) != tail:
        raise ValueError(f"{name}: expected int32 (..., {', '.join(map(str, tail))}), "
                         f"got {a.dtype} {tuple(a.shape)}")
    x = a.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    out = torch.empty(a.shape, dtype=torch.int32, device=x.device)
    n = out.numel() // (degree * N_LIMBS)
    if n == 0:
        return out
    lib = load()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"{name}_launch")(x.data_ptr(), out.data_ptr(), n, *extra,
                                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.error_string(rc).decode()}")
    launches[name] += 1
    sizes[name][n] = sizes[name].get(n, 0) + 1
    return out


def fq_inv(a: torch.Tensor) -> torch.Tensor:
    """K9: a^-1 in Fq (Montgomery form in and out) by binary GCD, one
    launch for the batch; 0 maps to 0."""
    return _elementwise("fq_inv", a, 1, _load_inv, INV_START)


def fq_pow(a: torch.Tensor, exp_bits) -> torch.Tensor:
    """K5: a^e in Fq (Montgomery form), e as its bits from the most
    significant, one launch for the chain; 0 maps to 0."""
    return _elementwise("fq_pow", a, 1, _load_pow, *_exponent(exp_bits))


def fq2_pow(a: torch.Tensor, exp_bits) -> torch.Tensor:
    """K6: a^e in Fq2 (``(..., 2, 32)``, u^2 = -1), one launch for the chain."""
    return _elementwise("fq2_pow", a, 2, _load_pow, *_exponent(exp_bits))


def _mul_static(name: str, pt, k: int, degree: int) -> tuple:
    tail = (N_LIMBS,) if degree == 1 else (2, N_LIMBS)
    for t in pt:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on {t.device}")
        if t.dtype != torch.int32 or tuple(t.shape[-degree:]) != tail:
            raise ValueError(f"{name}: expected int32 (..., {', '.join(map(str, tail))}), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if len({t.device for t in pt}) != 1:
        raise ValueError(f"{name}: coordinates on {[str(t.device) for t in pt]}")
    if not 0 < k < 1 << 384:
        raise ValueError(f"{name}: expected a scalar 0 < k < 2^384, got {k}")
    x, y, z = pt
    shape = _broadcast_shape(_broadcast_shape(x.shape, y.shape), z.shape)
    ins = []
    for t in pt:
        t = t.expand(shape).contiguous()
        ins.append(t.clone() if t.data_ptr() % 16 else t)
    outs = tuple(torch.empty(shape, dtype=torch.int32, device=x.device) for _ in range(3))
    n = outs[0].numel() // (degree * N_LIMBS)
    if n == 0:
        return outs
    words, length = _exponent(fq_plain.bits_msb(k))
    lib = _load_curve()
    fn = getattr(lib, f"{name}_launch")
    with torch.cuda.device(x.device):
        rc = fn(*(t.data_ptr() for t in ins + list(outs)), n, words, length,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.curve_error_string(rc).decode()}")
    launches[name] += 1
    sizes[name][n] = sizes[name].get(n, 0) + 1
    return outs


def g1_mul_static(pt, k: int) -> tuple:
    """K7: [k] P for Jacobian G1 points ``(X, Y, Z)``, each ``(..., 32)``,
    and a public scalar k > 0, one launch for the ladder (the formulas of
    ``curve_torch.ladder``, so the same limbs)."""
    return _mul_static("g1_mul_static", pt, k, 1)


def g2_mul_static(pt, k: int) -> tuple:
    """K8: the same on G2, each coordinate ``(..., 2, 32)``."""
    return _mul_static("g2_mul_static", pt, k, 2)


def _check_op(name: str, op: int) -> None:
    if op not in (0, 1, 2):
        raise ValueError(f"{name}: unknown op {op}")


def fq_mul_thread(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The first port's one-thread K3 (measurement only)."""
    return _launch("fq_mul_thread", a, b)


def fq_addsub_thread(a: torch.Tensor, b: torch.Tensor, op: int) -> torch.Tensor:
    """The first port's one-thread K4 (measurement only)."""
    _check_op("fq_addsub_thread", op)
    return _launch("fq_addsub_thread", a, b, op)
