"""Batched BLS backend on the card: the port of the JAX package's
``ops/bls_jax.py``, selected by ``bls.use_backend("torch")``.

Split of labour:
- Host: wire-format byte checks (flags, x < p), expand_message_xmd, the
  check bookkeeping. Python-object domain.
- Device (``device``, the CUDA card unless the CPU is asked for): pubkey
  decompression and subgroup checks, signature decompression and subgroup
  checks, hash-to-G2, pubkey aggregation, Miller loops and the final
  exponentiation, all on the limb tensors of ``ops/fq.py`` (kernels K3/K4).

One change of route from the JAX package, same semantics: a pubkey is
decoded once and cached by its bytes, as ``_pk_affine`` was, but the
misses are filled by one batched ``g1_decompress`` + ``g1_subgroup_mask``
on the device per call, not by host decode (pure-Python square root and
subgroup ladder, milliseconds a key). Accept/reject equals the host
decode's: invalid flags, x >= p, infinity, off-curve and out-of-subgroup
keys are rejected.

There is no fallback: a failure of the device path raises.

The Verify family matches the host ciphersuite exactly. Every call, the
scalar ones and the ``*_batch`` ones, runs every stage of its checks on
the device, one call a stage for the whole batch; the scalar functions
are batches of one.
"""
from __future__ import annotations

import functools
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..crypto.bls import ciphersuite as _host
from ..crypto.bls import fields as hf
from ..crypto.bls.curve import g1_generator
from . import curve_torch as cj, fq, h2c_torch as h2, pairing_torch, tower

G2_POINT_AT_INFINITY = _host.G2_POINT_AT_INFINITY

_device: Optional[torch.device] = None


def use_device(device=None) -> torch.device:
    """Set the backend's device: ``None`` is the CUDA card (raising
    without one); ``"cpu"`` runs the kernels' plain versions."""
    global _device
    dev = resolve_device(device)
    if dev != _device:
        clear_caches()
    _device = dev
    return dev


def device() -> torch.device:
    return _device if _device is not None else use_device()


# -- pubkeys: one batched device decode per call, cached by key bytes ----------

def _parse_g1_x(pubkey: bytes):
    """Compressed-G1 wire checks that stay on the host (byte logic,
    crypto/bls/curve.py:201-221): (x_mont_limbs, s_flag) or None. The
    infinity encoding is rejected whole: an infinity pubkey never verifies
    (crypto/bls/ciphersuite.py:64-68)."""
    if len(pubkey) != 48:
        return None
    flags = pubkey[0]
    if not flags & 0x80 or flags & 0x40:
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + pubkey[1:], "big")
    if x >= fq.P_INT:
        return None
    return tower.fq_to_limbs_mont(x), bool(flags & 0x20)


class _PubkeyTable:
    """Decoded pubkeys on the device: ``index`` maps key bytes to a row of
    ``x``/``y`` (affine Montgomery limbs), or -1 for a key that does not
    decode to a point of the subgroup."""

    def __init__(self, dev: torch.device):
        self.index: dict = {}
        self.x = torch.zeros((0, fq.N_LIMBS), dtype=torch.int32, device=dev)
        self.y = torch.zeros((0, fq.N_LIMBS), dtype=torch.int32, device=dev)
        self.decoded = 0  # keys decoded on the device so far

    def fill(self, pubkeys) -> None:
        misses = list(dict.fromkeys(pk for pk in pubkeys if pk not in self.index))
        parsed = []
        for pk in misses:
            p = _parse_g1_x(pk)
            if p is None:
                self.index[pk] = -1
            else:
                parsed.append((pk, p))
        if not parsed:
            return
        dev = self.x.device
        xs = torch.from_numpy(np.stack([p[0] for _, p in parsed])).to(dev)
        flags = torch.tensor([p[1] for _, p in parsed], device=dev)
        x, y, on_curve, in_subgroup = cj.g1_decompress(xs, flags)
        ok = (on_curve & in_subgroup).cpu().tolist()
        base = self.x.shape[0]
        self.x = torch.cat([self.x, x])
        self.y = torch.cat([self.y, y])
        self.decoded += len(parsed)
        for j, (pk, _) in enumerate(parsed):
            self.index[pk] = base + j if ok[j] else -1

    def rows(self, pubkeys) -> List[int]:
        self.fill(pubkeys)
        return [self.index[pk] for pk in pubkeys]


_table: Optional[_PubkeyTable] = None


def _pubkeys() -> _PubkeyTable:
    global _table
    if _table is None:
        _table = _PubkeyTable(device())
    return _table


def _pk_affine(pubkey: bytes) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Compressed G1 pubkey -> affine Montgomery limbs on the device, or
    None if it is invalid, infinity or outside the subgroup."""
    t = _pubkeys()
    row = t.rows([bytes(pubkey)])[0]
    return None if row < 0 else (t.x[row], t.y[row])


def clear_caches() -> None:
    global _table
    _table = None


@functools.lru_cache(maxsize=1)
def _neg_g1_limbs() -> Tuple[np.ndarray, np.ndarray]:
    x, y = g1_generator().neg().affine()
    return tower.fq_to_limbs_mont(int(x)), tower.fq_to_limbs_mont(int(y))


# -- the device pipeline: every stage on the device --------------------------------
#
#   pubkeys:    batched decompression + subgroup check, cached  (curve_torch)
#   signatures: sqrt-decompress + psi subgroup check            (curve_torch)
#   messages:   SSWU hash-to-curve                              (h2c_torch)
#   aggregate:  per-row Jacobian tree sum of the pubkeys (FAV)  (curve_torch)
#   decision:   Miller loops + fast final exponentiation        (pairing_torch)

STAGES = ("pubkey_decode", "signature_decompress", "hash_to_curve", "aggregate", "miller_loop",
          "final_exponentiation")
# seconds per stage, summed over calls since the last reset; each
# stage ends with a device synchronisation so that the times add up
stage_seconds = dict.fromkeys(STAGES, 0.0)


def reset_stage_seconds() -> None:
    for k in STAGES:
        stage_seconds[k] = 0.0


class _Stage:
    def __init__(self, name: str, dev: torch.device):
        self.name, self.dev = name, dev

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        stage_seconds[self.name] += time.perf_counter() - self.t0


def cold_shape_floors() -> Tuple[int, int]:
    """(max_rows, min_keys): the row cap and key floor the flush planner
    groups rows by (sched/bucketing.py). Nothing here recompiles per shape,
    so they only set how many calls a flush makes. On the card every
    stage is launch-bound (a call costs about the same at 2 rows or 256),
    so a block's flush should be ONE call: 128 keys covers the mainnet
    committee halves and pads the 1-key Verify rows into the same bucket,
    and 256 rows holds a block's 128 attestations plus its proposer and
    randao checks. On the CPU the plain versions cost by element, so the
    key floor is small."""
    if device().type == "cuda":
        return 256, 128
    return 256, 8


def _parse_g2_x(sig: bytes):
    """Compressed-G2 wire checks that stay on the host (byte logic,
    curve.py:223-243): (x_mont_limbs, s_flag) | "inf" | None."""
    sig = bytes(sig)
    if len(sig) != 96:
        return None
    flags = sig[0]
    if not flags & 0x80:
        return None
    if flags & 0x40:
        if any(sig[1:]) or (flags & ~0xC0):
            return None
        return "inf"
    x1 = int.from_bytes(bytes([flags & 0x1F]) + sig[1:48], "big")
    x0 = int.from_bytes(sig[48:], "big")
    if x0 >= fq.P_INT or x1 >= fq.P_INT:
        return None
    return tower.fq2_to_limbs_mont(hf.Fq2(x0, x1)), bool(flags & 0x20)


@functools.lru_cache(maxsize=1)
def _sig_pad():
    """A valid signature's parse: the G2 generator fills infinity rows."""
    from ..crypto.bls.curve import g2_generator, g2_to_bytes

    return _parse_g2_x(g2_to_bytes(g2_generator()))


def _verify_on_device(pubkey_lists, message_lists, signatures, aggregate: bool) -> np.ndarray:
    """Every stage of a batch of checks on the device, one call each.
    ``aggregate``: FastAggregateVerify, one message a row and the row's
    pubkeys summed into one pair; else AggregateVerify, one message and one
    pair per pubkey. Semantics identical to the host ciphersuite."""
    n = len(signatures)
    out = np.zeros(n, dtype=bool)
    if n == 0:
        return out
    dev = device()
    table = _pubkeys()
    sig_parsed = [_parse_g2_x(s) for s in signatures]
    with _Stage("pubkey_decode", dev):
        keyed = [i for i in range(n) if sig_parsed[i] is not None and len(pubkey_lists[i]) > 0
                 and (aggregate or len(message_lists[i]) == len(pubkey_lists[i]))]
        table.fill([bytes(pk) for i in keyed for pk in pubkey_lists[i]])
        rows = []  # (index, pubkey rows, parsed signature)
        for i in keyed:
            idx = [table.index[bytes(pk)] for pk in pubkey_lists[i]]
            if min(idx) >= 0:
                rows.append((i, idx, sig_parsed[i]))
    if not rows:
        return out
    b, k = len(rows), max(len(r[1]) for r in rows)

    with _Stage("signature_decompress", dev):
        pad_x, pad_flag = _sig_pad()
        sig_x = np.tile(pad_x, (b, 1, 1))
        sig_flag = np.full(b, pad_flag)
        sig_inf = np.zeros(b, dtype=bool)
        for r, (_, _, sp) in enumerate(rows):
            if sp == "inf":
                sig_inf[r] = True
            else:
                sig_x[r], sig_flag[r] = sp
        inf_t = torch.from_numpy(sig_inf).to(dev)
        qx_sig, qy_sig, on_curve, in_subgroup = cj.g2_decompress(
            torch.from_numpy(sig_x).to(dev), torch.from_numpy(sig_flag).to(dev))
        sig_ok = (on_curve & in_subgroup) | inf_t

    idx = np.zeros((b, k), dtype=np.int64)
    active = np.zeros((b, k), dtype=bool)
    for r, (_, pk_rows, _) in enumerate(rows):
        idx[r, : len(pk_rows)] = pk_rows
        active[r, : len(pk_rows)] = True
    active_t = torch.from_numpy(active).to(dev)

    with _Stage("hash_to_curve", dev):
        if aggregate:
            msgs = [bytes(message_lists[i]) for i, _, _ in rows]
        else:
            msgs = [bytes(m) for i, _, _ in rows for m in message_lists[i]]
        u = torch.from_numpy(h2.messages_to_field_limbs(msgs)).to(dev)
        qx_msg, qy_msg = h2.hash_to_g2_affine(u)
        if aggregate:  # one message pair a row
            qx_msg, qy_msg = qx_msg.unsqueeze(1), qy_msg.unsqueeze(1)
        else:  # the flat hashes spread over the rows' (b, k) pairs
            flat = np.zeros((b, k), dtype=np.int64)
            flat[active] = np.arange(len(msgs))
            flat_t = torch.from_numpy(flat).to(dev)
            qx_msg, qy_msg = qx_msg[flat_t], qy_msg[flat_t]

    with _Stage("aggregate", dev):
        idx_t = torch.from_numpy(idx).to(dev)
        px, py = table.x[idx_t], table.y[idx_t]
        if aggregate:
            z = torch.where(active_t.unsqueeze(-1), cj.FQ.one((), dev), cj.FQ.zero((), dev))
            agg_x, agg_y, agg_inf = cj.jac_to_affine(cj.FQ, cj.jac_tree_sum(cj.FQ, (px, py, z), active_t))
            px, py, active_t = agg_x.unsqueeze(1), agg_y.unsqueeze(1), ~agg_inf.unsqueeze(1)

    with _Stage("miller_loop", dev):
        gx, gy = (fq.const(a, dev).expand(b, 1, fq.N_LIMBS) for a in _neg_g1_limbs())
        f = pairing_torch.miller_reduce(
            torch.cat([gx, px], dim=1), torch.cat([gy, py], dim=1),
            torch.cat([qx_sig.unsqueeze(1), qx_msg], dim=1), torch.cat([qy_sig.unsqueeze(1), qy_msg], dim=1),
            torch.cat([~inf_t.unsqueeze(1), active_t], dim=1))

    with _Stage("final_exponentiation", dev):
        ok = tower.fq12_is_one(pairing_torch.final_exponentiation_fast(f)) & sig_ok
        ok = ok.cpu().tolist()
    for r, (i, _, _) in enumerate(rows):
        out[i] = ok[r]
    return out


# -- generic pairing checks: lists of pairs whose pairing product must be 1 ------
#
# A "check" is a list of pairs [(g1_limbs | None, g2_limbs | "inf")], each
# side affine Montgomery limbs (numpy): G1 (x, y) of (32,), G2 (x, y) of
# (2, 32). None in a pair's G1 slot means the negated generator; an "inf"
# G2 leaves the pair inactive (it contributes 1). A check of None is
# statically False (malformed input, never sent to the device). The KZG
# verifiers (ops/kzg_torch.py) build their rows as such checks.

_CPU_MAX_ROWS = 8  # on the CPU the plain versions cost by row


def _pack_checks(checks):
    """Checks of at least one pair packed into (len, max pairs) limb arrays
    for ``pairing_torch``: (px, py, qx, qy, active). Pad pairs are the
    negated generator, inactive."""
    b, k = len(checks), max(len(c) for c in checks)
    gx, gy = _neg_g1_limbs()
    px = np.tile(gx, (b, k, 1))
    py = np.tile(gy, (b, k, 1))
    qx = np.zeros((b, k, 2, fq.N_LIMBS), dtype=np.int32)
    qy = np.zeros((b, k, 2, fq.N_LIMBS), dtype=np.int32)
    active = np.zeros((b, k), dtype=bool)
    for row, check in enumerate(checks):
        for col, (p, q) in enumerate(check):
            if p is not None:
                px[row, col] = p[0]
                py[row, col] = p[1]
            if isinstance(q, str) and q == "inf":
                continue  # the pair contributes 1: left inactive
            qx[row, col] = q[0]
            qy[row, col] = q[1]
            active[row, col] = True
    return px, py, qx, qy, active


def run_checks(checks) -> np.ndarray:
    """One bool a check: its pairing product is 1. The live checks go to the
    device in calls of at most ``cold_shape_floors()[0]`` rows on the card
    (a call's launches do not depend on its rows, so a full block's 256
    shard headers are one call) and 8 on the CPU, each a batched Miller
    loop and fast final exponentiation (``pairing_torch``), timed in
    ``stage_seconds`` under "miller_loop" and "final_exponentiation"."""
    out = np.zeros(len(checks), dtype=bool)
    live = [i for i, c in enumerate(checks) if c is not None and len(c) > 0]
    dev = device()
    cap = cold_shape_floors()[0] if dev.type == "cuda" else _CPU_MAX_ROWS
    for start in range(0, len(live), cap):
        sub = live[start : start + cap]
        px, py, qx, qy, active = (torch.from_numpy(a).to(dev) for a in _pack_checks([checks[i] for i in sub]))
        with _Stage("miller_loop", dev):
            f = pairing_torch.miller_reduce(px, py, qx, qy, active)
        with _Stage("final_exponentiation", dev):
            ok = tower.fq12_is_one(pairing_torch.final_exponentiation_fast(f)).cpu().tolist()
        out[sub] = ok
    return out


# -- the API (crypto/bls/ciphersuite.py parity): every call is the device pipeline --

def fast_aggregate_verify_batch(pubkey_lists, messages, signatures) -> np.ndarray:
    """Element-wise FastAggregateVerify over a batch."""
    return _verify_on_device(pubkey_lists, messages, signatures, aggregate=True)


def verify_batch(pubkeys, messages, signatures) -> np.ndarray:
    """Element-wise Verify over a batch (rows of one key)."""
    return fast_aggregate_verify_batch([[pk] for pk in pubkeys], messages, signatures)


def aggregate_verify_batch(pubkey_lists, message_lists, signatures) -> np.ndarray:
    """Element-wise AggregateVerify over a batch."""
    return _verify_on_device(pubkey_lists, message_lists, signatures, aggregate=False)


# the JAX package's names for the pipeline that caches nothing but the
# pubkeys; in the port every call is that pipeline
fast_aggregate_verify_batch_cold = fast_aggregate_verify_batch
verify_batch_cold = verify_batch


def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    return bool(verify_batch([pubkey], [message], [signature])[0])


def AggregateVerify(pubkeys, messages, signature: bytes) -> bool:
    return bool(aggregate_verify_batch([pubkeys], [messages], [signature])[0])


def FastAggregateVerify(pubkeys, message: bytes, signature: bytes) -> bool:
    return bool(fast_aggregate_verify_batch([pubkeys], [message], [signature])[0])


# host-domain primitives: the oracle's own
Aggregate = _host.Aggregate
AggregatePKs = _host.AggregatePKs
Sign = _host.Sign
SkToPk = _host.SkToPk
KeyValidate = _host.KeyValidate
signature_to_G2 = _host.signature_to_G2
