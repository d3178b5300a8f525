"""Batched BLS12-381 base-field arithmetic: the port of the JAX package's
``ops/fq.py``, on the same layout.

A field element is a ``(..., 32)`` int32 tensor of canonical 12-bit limbs,
little-endian, in Montgomery form with radix R = 2^384; every function
broadcasts over the leading dimensions and returns canonical limbs, so
limb tensors compare directly with the JAX package's arrays.

The multiply and the add/sub/neg are the two kernels of ``csrc/fq.cu``,
the static-exponent powers the two kernels of ``csrc/fq_pow.cu``, the
inverse the kernel of ``csrc/fq_inv.cu``:

- ``mul`` (K3 ``fq_mul``): the Montgomery product a b / R mod p;
- ``add``/``sub``/``neg`` (K4 ``fq_addsub``);
- ``pow_bits`` (K5 ``fq_pow``): a^e for a public exponent, one launch a
  chain;
- ``inv`` (K9 ``fq_inv``): a^-1 by binary GCD, one launch (its plain
  version is Fermat's a^(p-2), ``pow_bits``'s);
- ``fq2_pow_bits`` (K6 ``fq2_pow``): the same in Fq2, for the tower.

On a CPU tensor each computes with its plain PyTorch version
(``fq_plain``); on a CUDA tensor it launches the kernel or raises. Every
op above this module (the tower, the curve, hash-to-curve, the pairing)
stands on these.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fq_cuda, fq_plain

P_INT = fq_plain.P_INT
LIMB_BITS = fq_plain.LIMB_BITS
N_LIMBS = fq_plain.N_LIMBS
LIMB_MASK = fq_plain.LIMB_MASK
R_INT = fq_plain.R_INT


def _to_limbs_int(v: int) -> np.ndarray:
    return fq_plain.limbs_of(v).astype(np.int32)


P_LIMBS = _to_limbs_int(P_INT)
R2_INT = (R_INT * R_INT) % P_INT
R2_LIMBS = _to_limbs_int(R2_INT)
ONE_MONT = _to_limbs_int(R_INT % P_INT)  # 1 in Montgomery form
ONE_PLAIN = _to_limbs_int(1)

_CONSTS: dict = {}


def const(array: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant as a tensor on ``device``, made once
    per device and kept."""
    key = (id(array), str(device))
    hit = _CONSTS.get(key)
    if hit is None:
        hit = _CONSTS[key] = (array, torch.as_tensor(np.asarray(array)).to(device))
    return hit[1]


# -- host <-> tensor conversion ----------------------------------------------

def to_limbs(values) -> np.ndarray:
    """ints (nested lists ok) -> (..., 32) int32 limb array (plain form)."""
    arr = np.asarray(values, dtype=object)
    out = np.zeros(arr.shape + (N_LIMBS,), dtype=np.int32)
    for idx in np.ndindex(arr.shape):
        out[idx] = _to_limbs_int(int(arr[idx]))
    return out


def from_limbs(limbs) -> np.ndarray:
    """(..., 32) limbs (array or tensor) -> object array of ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs)
    out = np.empty(arr.shape[:-1], dtype=object)
    for idx in np.ndindex(arr.shape[:-1]):
        v = 0
        for i in range(N_LIMBS):
            v += int(arr[idx + (i,)]) << (LIMB_BITS * i)
        out[idx] = v
    return out if out.shape else out[()]


# -- the two kernels -----------------------------------------------------------

def _addsub(a: torch.Tensor, b: torch.Tensor, op: int) -> torch.Tensor:
    if a.device.type == "cpu":
        return fq_plain.addsub(a, b, op)
    if a.device.type == "cuda":
        return fq_cuda.fq_addsub(a, b, op)
    raise ValueError(f"fq: no kernel for device {a.device}")


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p, both < p."""
    return _addsub(a, b, fq_plain.OP_ADD)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, both < p."""
    return _addsub(a, b, fq_plain.OP_SUB)


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p; 0 maps to 0."""
    return _addsub(a, a, fq_plain.OP_NEG)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product: a b / R mod p (inputs and outputs in Montgomery form)."""
    if a.device.type == "cpu":
        return fq_plain.mul(a, b)
    if a.device.type == "cuda":
        return fq_cuda.fq_mul(a, b)
    raise ValueError(f"fq: no kernel for device {a.device}")


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """plain -> Montgomery form (a R mod p)."""
    return mul(a, const(R2_LIMBS, a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> plain form (a / R mod p): the product with plain 1."""
    return mul(a, const(ONE_PLAIN, a.device))


def pow_bits(a: torch.Tensor, bits) -> torch.Tensor:
    """a^e in Montgomery form, e given as its bits from the most significant
    (a static list): square-and-multiply over the bits in one call. Maps 0
    to 0."""
    if a.device.type == "cpu":
        return fq_plain.pow_bits(a, bits)
    if a.device.type == "cuda":
        return fq_cuda.fq_pow(a, bits)
    raise ValueError(f"fq: no kernel for device {a.device}")


def fq2_pow_bits(a: torch.Tensor, bits) -> torch.Tensor:
    """``pow_bits`` in Fq2: ``a`` is ``(..., 2, 32)``, a0 + a1 u with
    u^2 = -1."""
    if a.device.type == "cpu":
        return fq_plain.fq2_pow_bits(a, bits)
    if a.device.type == "cuda":
        return fq_cuda.fq2_pow(a, bits)
    raise ValueError(f"fq: no kernel for device {a.device}")


_P_MINUS_2_BITS = [(P_INT - 2) >> i & 1 for i in range((P_INT - 2).bit_length() - 1, -1, -1)]


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^-1 in Montgomery form; maps 0 to 0. On the card K9's binary GCD;
    its plain version is Fermat's a^(p-2) over the 381 exponent bits, the
    same canonical limbs."""
    if a.device.type == "cpu":
        return fq_plain.pow_bits(a, _P_MINUS_2_BITS)
    if a.device.type == "cuda":
        return fq_cuda.fq_inv(a)
    raise ValueError(f"fq: no kernel for device {a.device}")


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a >= b over canonical limbs: a > b at the most
    significant differing limb, or all equal."""
    a, b = torch.broadcast_tensors(a, b)
    diff = a != b
    # index of the most significant differing limb (0 where all are equal)
    idx = torch.where(diff, torch.arange(N_LIMBS, device=a.device), -1).amax(-1)
    top = idx.clamp(min=0).unsqueeze(-1)
    gt = torch.gather(a, -1, top) > torch.gather(b, -1, top)
    return gt.squeeze(-1) | (idx < 0)
