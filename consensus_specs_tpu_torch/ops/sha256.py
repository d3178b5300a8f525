"""Batched SHA-256 for SSZ Merkleization on the card.

The counterpart of the JAX package's ``ops/sha256.py`` (XLA graphs) and
``ops/sha256_pallas.py`` (the Pallas kernel): both become the two kernels
of ``csrc/sha256.cu``.

- ``sha256_blocks`` (K1): SHA-256 of 64-byte messages, the Merkle node hash.
- ``sha256_raw_blocks`` (K2): one compression over host-padded blocks of
  messages of at most 55 bytes.

Tensors are int32 whose memory is the message or digest bytes (see
``sha256_plain``). On a CPU tensor each wrapper computes with the plain
PyTorch version; on a CUDA tensor it launches the kernel or raises.

The multi-level reductions (``merkle_reduce``, ``merkle_levels``,
``item_roots``) are loops of K1 launches over tensors that stay on the
device: a level's digests, read as rows of 16 words, are the next level's
messages, so no byte is moved between levels.

The five ``*_device`` functions are the ``ssz.hashing`` seams;
``use_device_hasher`` installs them.
"""
from __future__ import annotations

import functools
import time
import warnings
from typing import Optional

import torch

from .. import resolve_device
from ..ssz import hashing
from ..ssz.merkle import ZERO_HASHES, ceil_log2, next_pow2
from . import sha256_cuda, sha256_plain


def _dispatch(name: str, blocks: torch.Tensor) -> torch.Tensor:
    if blocks.device.type == "cpu":
        return getattr(sha256_plain, name)(blocks)
    if blocks.device.type == "cuda":
        return getattr(sha256_cuda, name)(blocks)
    raise ValueError(f"{name}: no kernel for device {blocks.device}")


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(N, 16) int32 64-byte messages -> (N, 8) int32 SHA-256 digests."""
    return _dispatch("sha256_blocks", blocks)


def sha256_raw_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """(N, 16) int32 host-padded blocks -> (N, 8) one-compression digests."""
    return _dispatch("sha256_raw_blocks", blocks)


def merkle_reduce(chunks: torch.Tensor, levels: int) -> torch.Tensor:
    """Root (8,) of ``2**levels`` (N, 8) chunks: one K1 launch per level."""
    for _ in range(levels):
        chunks = sha256_blocks(chunks.view(-1, 16))
    return chunks[0]


def merkle_levels(chunks: torch.Tensor, levels: int) -> list:
    """Every interior level of ``2**levels`` chunks, height 1 upward."""
    out = []
    for _ in range(levels):
        chunks = sha256_blocks(chunks.view(-1, 16))
        out.append(chunks)
    return out


def item_roots(chunks: torch.Tensor, levels: int) -> torch.Tensor:
    """Roots (N, 8) of N independent ``2**levels``-chunk subtrees laid out
    item-major in (N * 2**levels, 8) chunks: pairs never cross items."""
    for _ in range(levels):
        chunks = sha256_blocks(chunks.view(-1, 16))
    return chunks


# --- byte-facing seams -------------------------------------------------------


def counters() -> dict:
    """Kernel launches and bytes, and bytes hashed on the host, since the
    last ``reset_counters()``."""
    return {
        "launches": dict(sha256_cuda.launches),
        "kernel_bytes": dict(sha256_cuda.bytes_in),
        "host_bytes": hashing.host_bytes,
    }


def reset_counters() -> None:
    sha256_cuda.reset_counters()
    hashing.reset_host_bytes()


def _upload(data: bytes, words_per_row: int, device: torch.device) -> torch.Tensor:
    with warnings.catch_warnings():
        # a read-only buffer: nothing writes into it (it is copied to the
        # card, or read by the plain version)
        warnings.simplefilter("ignore", UserWarning)
        host = torch.frombuffer(data, dtype=torch.int32)
    return host.view(-1, words_per_row).to(device)


def _download(words: torch.Tensor) -> bytes:
    return words.cpu().numpy().tobytes()


def _padded_chunks(chunks: bytes, device: torch.device) -> torch.Tensor:
    """The chunks, zero-padded on the device to the next power of two."""
    n = len(chunks) // 32
    out = torch.zeros((next_pow2(n), 8), dtype=torch.int32, device=device)
    out[:n] = _upload(chunks, 8, device)
    return out


def hash_many_device(data: bytes, device=None) -> bytes:
    """``hashing`` backend: SHA-256 of each 64-byte block of ``data``."""
    device = resolve_device(device)
    if not data:
        return b""
    return _download(sha256_blocks(_upload(data, 16, device)))


def merkle_root_device(chunks: bytes, limit: int, device=None) -> bytes:
    """Root of the zero-padded Merkle tree over packed 32-byte chunks: one
    upload, one K1 launch per level, a 32-byte download."""
    device = resolve_device(device)
    n = len(chunks) // 32
    depth = ceil_log2(max(limit, 1))
    if n == 0:
        return ZERO_HASHES[depth]
    level = ceil_log2(n)
    root = _download(merkle_reduce(_padded_chunks(chunks, device), level))
    while level < depth:
        root = hashing.hash_many(root + ZERO_HASHES[level])
        level += 1
    return root


def hash_small_device(messages, device=None) -> list:
    """Batched SHA-256 of <=55-byte messages: each is padded into one
    64-byte block on the host, then one K2 launch hashes the batch."""
    device = resolve_device(device)
    m = len(messages)
    if m == 0:
        return []
    buf = bytearray(m * 64)
    for i, msg in enumerate(messages):
        n = len(msg)
        if n > 55:
            raise ValueError(f"hash_small_device: message too long ({n} > 55)")
        off = i * 64
        buf[off : off + n] = msg
        buf[off + n] = 0x80
        buf[off + 56 : off + 64] = (8 * n).to_bytes(8, "big")
    raw = _download(sha256_raw_blocks(_upload(bytes(buf), 16, device)))
    return [raw[32 * i : 32 * i + 32] for i in range(m)]


def tree_levels_device(leaves: bytes, device=None) -> list:
    """All interior levels of the pow2-padded chunk tree (``hashing`` tree
    backend), as packed level bytes from height 1 up."""
    device = resolve_device(device)
    chunks = _padded_chunks(leaves, device)
    return [_download(lv) for lv in merkle_levels(chunks, ceil_log2(chunks.shape[0]))]


def item_roots_device(packed: bytes, chunks_per_item: int, device=None) -> bytes:
    """Roots of N independent ``chunks_per_item`` (= 2^k) chunk subtrees
    laid out item-major in ``packed``; the download is N * 32 bytes."""
    device = resolve_device(device)
    chunks = _upload(packed, 8, device)
    return _download(item_roots(chunks, ceil_log2(chunks_per_item)))


def calibrate_thresholds(device=None) -> dict:
    """Measure the device's fixed cost per call and its cost per byte
    against hashlib on the host, and set the ``hashing`` size thresholds so
    the device only gets the batches it wins. Can conclude that the device
    never wins, and then routes everything to the host."""
    device = resolve_device(device)
    data = b"\x5a" * (1 << 20)
    t0 = time.perf_counter()
    hashing._hashlib_hash_many(data)
    host_bps = len(data) / (time.perf_counter() - t0)

    def timed_root(n: int) -> float:
        words = torch.zeros((n, 8), dtype=torch.int32)
        _download(merkle_reduce(words.to(device), ceil_log2(n)))  # warm up (and build)
        t0 = time.perf_counter()
        _download(merkle_reduce(words.to(device), ceil_log2(n)))
        return time.perf_counter() - t0

    floor_s = timed_root(64)
    big_n = 1 << 17  # 4 MiB of chunks
    slope = max((timed_root(big_n) - floor_s) / (big_n * 32), 1e-12)  # s/byte incl. upload

    host_sbp = 1.0 / host_bps
    if host_sbp > slope:
        hashing.FUSED_ROOT_MIN_CHUNKS = max(128, int(floor_s / (host_sbp - slope) // 32))
    else:
        hashing.FUSED_ROOT_MIN_CHUNKS = 1 << 62  # device never wins
    # hash_many brings half the data back: count the download like the upload
    hm_slope = slope * 1.5
    if host_sbp > hm_slope:
        hashing.DEVICE_MIN_BLOCKS = max(64, int(floor_s / (host_sbp - hm_slope) // 64))
    else:
        hashing.DEVICE_MIN_BLOCKS = 1 << 62
    return {
        "host_mibs": host_bps / (1 << 20),
        "floor_ms": floor_s * 1e3,
        "slope_ns_per_byte": slope * 1e9,
        "fused_min_chunks": hashing.FUSED_ROOT_MIN_CHUNKS,
        "device_min_blocks": hashing.DEVICE_MIN_BLOCKS,
    }


def use_device_hasher(device=None, calibrate: bool = True) -> Optional[dict]:
    """Install the five seams as the SSZ Merkleization backend, on
    ``device`` (``None``: the CUDA card, raising when there is none).

    With ``calibrate`` (default), measures the device against the host and
    sets the routing thresholds (see ``calibrate_thresholds``), and returns
    that report; ``calibrate=False`` keeps the default thresholds."""
    device = resolve_device(device)
    hashing.set_backend(functools.partial(hash_many_device, device=device), name=f"torch-{device.type}")
    hashing.set_small_backend(functools.partial(hash_small_device, device=device))
    hashing.set_fused_root_backend(functools.partial(merkle_root_device, device=device))
    hashing.set_tree_backend(functools.partial(tree_levels_device, device=device))
    hashing.set_item_roots_backend(functools.partial(item_roots_device, device=device))
    if calibrate:
        return calibrate_thresholds(device)
    return None


def use_host_hasher() -> None:
    hashing.set_backend(None)
    hashing.set_small_backend(None)
    hashing.set_fused_root_backend(None)
    hashing.set_tree_backend(None)
    hashing.set_item_roots_backend(None)
