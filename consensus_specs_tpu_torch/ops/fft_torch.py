"""Batched Fr (BLS12-381 scalar field) arithmetic and the radix-2 FFT: the
port of the JAX package's ``ops/fft_jax.py`` under its names, on its layout
(``(..., 22)`` int32 canonical 12-bit limbs, Montgomery radix 2^264), the
compute core of DAS data extension and KZG polynomial work.

On a CUDA tensor each function launches the kernels of ``csrc/fr_fft.cu``
(``fr_cuda``): ``mul``/``to_mont``/``from_mont`` and ``add``/``sub`` K12
``fr_mul``, ``fft`` K11 ``fr_fft``, ``das_extension`` two K11 transforms.
On a CPU tensor each runs its plain version (``fr_plain``); any other
device raises. ``fft_device`` and ``das_fft_extension_device`` take and
return Python ints and run on the card unless the caller asks for the CPU.

Host oracle: crypto/fr.py (tested bit-identical).
"""
from __future__ import annotations

import torch

from .. import resolve_device
from . import fr_cuda, fr_plain

to_limbs = fr_plain.to_limbs
from_limbs = fr_plain.from_limbs


def _pointwise(a: torch.Tensor, b: torch.Tensor, op: int, plain) -> torch.Tensor:
    if a.device.type == "cpu":
        return plain(a, b)
    if a.device.type == "cuda":
        return fr_cuda.fr_mul(a, b, op)
    raise ValueError(f"fft_torch: no kernel for device {a.device}")


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod r, both below r."""
    return _pointwise(a, b, fr_cuda.OP_ADD, fr_plain.add)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod r, both below r."""
    return _pointwise(a, b, fr_cuda.OP_SUB, fr_plain.sub)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Montgomery product a b / 2^264 mod r."""
    return _pointwise(a, b, fr_cuda.OP_MUL, fr_plain.mul)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    return mul(a, torch.from_numpy(fr_plain.R2_LIMBS).to(a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    return mul(a, torch.from_numpy(fr_plain.ONE_PLAIN).to(a.device))


def fft(vals_mont: torch.Tensor, n: int, inverse: bool = False) -> torch.Tensor:
    """``fft_jit``: the transform of (n, 22) Montgomery limbs (n a power of
    two); on the inverse, scaled by n^-1. A transform of one element is
    that element."""
    if n == 1:
        return vals_mont.clone()
    if vals_mont.device.type == "cpu":
        return fr_plain.fft(vals_mont, n, inverse)
    if vals_mont.device.type == "cuda":
        return fr_cuda.fr_fft(vals_mont, n, inverse)
    raise ValueError(f"fft_torch: no kernel for device {vals_mont.device}")


def das_extension(data_mont: torch.Tensor, n: int) -> torch.Tensor:
    """``das_extension_jit`` (das-core.md:90-97): the inverse transform at
    n, a zero pad to 2n, the forward transform, the odd outputs."""
    poly = fft(data_mont, n, inverse=True)
    full = fft(torch.cat([poly, torch.zeros_like(poly)]), 2 * n)
    return full[1::2]


def fft_device(values, inverse: bool = False, device=None) -> list:
    """The FFT of Python ints on ``device`` (None: the CUDA card); Python
    ints out."""
    dev = resolve_device(device)
    vals = to_mont(torch.from_numpy(to_limbs(values)).to(dev))
    return list(from_limbs(from_mont(fft(vals, len(values), inverse))))


def das_fft_extension_device(data, device=None) -> list:
    """``das_fft_extension`` of Python ints on ``device`` (None: the CUDA
    card); Python ints out."""
    dev = resolve_device(device)
    vals = to_mont(torch.from_numpy(to_limbs(data)).to(dev))
    return list(from_limbs(from_mont(das_extension(vals, len(data)))))
