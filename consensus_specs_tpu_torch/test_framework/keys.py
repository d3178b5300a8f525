"""Deterministic test keypairs: privkey(i) = i + 1 (ref: test/helpers/
keys.py:1-6). Pubkeys are derived lazily and cached for the session —
the reference precomputes 8192 eagerly with native BLS; with the pure-host
scalar-mul here, laziness keeps import instant."""
from __future__ import annotations

from typing import Dict

from consensus_specs_tpu_torch.crypto.bls import ciphersuite


class _LazyPubkeys:
    """Sequence-like view: pubkeys[i] == SkToPk(i + 1)."""

    def __init__(self):
        self._cache: Dict[int, bytes] = {}

    def __getitem__(self, i: int) -> bytes:
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(1 << 14))]
        if i < 0:
            i += 1 << 14
        pk = self._cache.get(i)
        if pk is None:
            pk = ciphersuite.SkToPk(i + 1)
            self._cache[i] = pk
            pubkey_to_privkey[pk] = i + 1
        return pk


def privkey(index: int) -> int:
    return index + 1


class _Privkeys:
    def __getitem__(self, i: int) -> int:
        if i < 0:
            i += 1 << 14
        return i + 1


privkeys = _Privkeys()
pubkeys = _LazyPubkeys()
pubkey_to_privkey: Dict[bytes, int] = {}


def aggregate_sign(sks, signing_root: bytes):
    """Aggregate signature of many keys over ONE message, computed as a
    single Sign under the summed secret key: by linearity,
    sum_i(sk_i·H(m)) == (sum_i sk_i mod r)·H(m), so the compressed bytes
    are identical to Aggregate([Sign(sk_i, m)]) at ~1/k the cost (one
    G2 scalar-mult instead of k). The reference helpers pay the per-key
    loop (test/helpers/attestations.py:83-87) because py_ecc gives them
    no cheaper algebra; the equivalence is pinned by
    tests/test_gen_pipeline.py::test_aggregate_sign_matches_per_key_path.

    Funnels through the facade's Aggregate so the bls_active=False
    behavior (G2_POINT_AT_INFINITY) is exactly the per-key path's.
    """
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.crypto.bls.fields import R

    sks = list(sks)
    assert len(sks) > 0
    agg_sk = sum(int(sk) for sk in sks) % R
    return bls.Aggregate([bls.Sign(agg_sk, signing_root)])
