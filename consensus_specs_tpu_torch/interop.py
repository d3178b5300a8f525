"""Carry values across from the JAX package: SSZ bytes in, the port's
types out; numpy word arrays in, the kernels' tensor layout out.

A state or block crosses as its SSZ serialization (``encode_bytes()`` on
either side), which both packages define identically, so this module needs
nothing of the JAX package itself.
"""
from __future__ import annotations

import numpy as np
import torch

from .specs import build_spec


def state_from_reference(ssz_bytes: bytes, fork: str = "phase0", preset: str = "minimal"):
    """The port's ``BeaconState`` of ``fork``/``preset`` decoded from SSZ bytes."""
    return build_spec(fork, preset).BeaconState.decode_bytes(bytes(ssz_bytes))


def block_from_reference(ssz_bytes: bytes, fork: str = "phase0", preset: str = "minimal"):
    """The port's ``SignedBeaconBlock`` decoded from SSZ bytes."""
    return build_spec(fork, preset).SignedBeaconBlock.decode_bytes(bytes(ssz_bytes))


def words_from_numpy(a: np.ndarray) -> torch.Tensor:
    """uint32 SHA-256 words (the JAX package's layout: word values) -> the
    int32 tensor the kernels take (its memory is the big-endian bytes)."""
    be = np.ascontiguousarray(np.asarray(a, dtype=np.uint32).astype(">u4"))
    return torch.from_numpy(be.view(np.int32).copy())


def words_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of ``words_from_numpy``: kernel output -> uint32 word values."""
    return t.detach().cpu().contiguous().numpy().view(">u4").astype(np.uint32)
