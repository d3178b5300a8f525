"""consensus_specs_tpu_torch — the PyTorch/CUDA port of consensus_specs_tpu.

The same executable consensus specs (SSZ types and Merkleization, the BLS
facade, the phase0 beacon chain), with SSZ Merkleization on SHA-256 kernels
written by hand for NVIDIA Hopper (`ops/csrc/sha256.cu`). It imports
neither JAX nor the JAX package: the pure-Python modules it needs are
copies kept here, under the same layout.

Device policy: entry points take an explicit ``device``. ``None`` means the
CUDA card and raises when there is none; the CPU runs only when a caller
asks for it with ``device="cpu"`` (the tests do), and then each kernel's
plain PyTorch version computes the same bytes.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> the current CUDA device, raising when CUDA is absent;
    anything else -> that device, as asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: consensus_specs_tpu_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
