"""The port's BLS backend (``ops/bls_torch.py`` behind the facade's
``DeferredVerifier``, on ``device="cpu"``: the plain versions of K3/K4)
against the JAX package's host oracle and reference backend.

One module-scoped flush resolves every check of this file: the Verify,
FastAggregateVerify and AggregateVerify parity cases of
``tests/test_bls_device.py`` and ``tests/test_bls_cold.py``, and the
signature checks of two minimal-preset phase0 blocks (a signed block with
split committee aggregates, and its tampered copy). The tests read that
flush's answers.

The slice as a whole: the same genesis and blocks through the port
(deferred, one flush) and through the JAX package (reference backend,
BLS on) reach the same post-state root, and both reject the tampered
block."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import bls as jbls
from consensus_specs_tpu.crypto.bls import ciphersuite as host
from consensus_specs_tpu.crypto.bls import curve as hc
from consensus_specs_tpu.crypto.bls import fields as hf
from consensus_specs_tpu.ops import bls_jax
from consensus_specs_tpu.specs import build_spec as jbuild
from consensus_specs_tpu.test_framework.context import (
    _prepare_state,
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu_torch import harness
from consensus_specs_tpu_torch.crypto import bls as tbls
from consensus_specs_tpu_torch.ops import bls_torch, tower
from consensus_specs_tpu_torch.specs import build_spec as tbuild

SKS = [i + 1 for i in range(8)]
PKS = [host.SkToPk(sk) for sk in SKS]
MSG = b"\xab" * 32
INF = bytes(host.G2_POINT_AT_INFINITY)


def _parity_cases():
    """(name, recorder, expected): each recorder makes one facade call."""
    sig = host.Sign(SKS[0], MSG)
    tampered = bytearray(sig)
    tampered[-1] ^= 1
    agg = host.Aggregate([host.Sign(sk, MSG) for sk in SKS])
    msgs = [bytes([i]) * 32 for i in range(4)]
    agg_av = host.Aggregate([host.Sign(sk, m) for sk, m in zip(SKS[:4], msgs)])
    cold_msg = [bytes([7, i]) * 16 for i in range(3)]
    cold_sig = [host.Aggregate([host.Sign(sk, m) for sk in SKS[i : i + 3]]) for i, m in enumerate(cold_msg)]
    return [
        ("verify", lambda: tbls.Verify(PKS[0], MSG, sig), True),
        ("verify wrong key", lambda: tbls.Verify(PKS[1], MSG, sig), False),
        ("verify wrong message", lambda: tbls.Verify(PKS[0], b"\xcd" * 32, sig), False),
        ("verify tampered signature", lambda: tbls.Verify(PKS[0], MSG, bytes(tampered)), False),
        ("verify malformed signature", lambda: tbls.Verify(PKS[0], MSG, b"\x00" * 96), False),
        ("verify infinity signature", lambda: tbls.Verify(PKS[0], MSG, INF), False),
        ("verify row 2 with row 3's signature", lambda: tbls.Verify(PKS[2], cold_msg[0], cold_sig[1]), False),
        ("fav", lambda: tbls.FastAggregateVerify(PKS, MSG, agg), True),
        ("fav missing key", lambda: tbls.FastAggregateVerify(PKS[:-1], MSG, agg), False),
        ("fav no keys", lambda: tbls.FastAggregateVerify([], MSG, agg), False),
        ("fav infinity signature", lambda: tbls.FastAggregateVerify(PKS, MSG, INF), False),
        ("fav fresh 0", lambda: tbls.FastAggregateVerify(PKS[0:3], cold_msg[0], cold_sig[0]), True),
        ("fav fresh 1 wrong message", lambda: tbls.FastAggregateVerify(PKS[1:4], b"\x99" * 32, cold_sig[1]), False),
        ("fav fresh 2", lambda: tbls.FastAggregateVerify(PKS[2:5], cold_msg[2], cold_sig[2]), True),
        ("fav invalid key", lambda: tbls.FastAggregateVerify([PKS[0], b"\x00" * 48], MSG, sig), False),
        ("av", lambda: tbls.AggregateVerify(PKS[:4], msgs, agg_av), True),
        ("av reordered messages", lambda: tbls.AggregateVerify(PKS[:4], msgs[::-1], agg_av), False),
        ("av no keys", lambda: tbls.AggregateVerify([], [], agg_av), False),
    ]


@pytest.fixture(scope="module")
def flushed():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_active = tbls.bls_active
    jspec, tspec = jbuild("phase0", "minimal"), tbuild("phase0", "minimal")
    jstate = _prepare_state(default_balances, default_activation_threshold, jspec)
    pre = harness.genesis(tspec, len(jstate.validators))
    post = pre.copy()
    good = harness.next_block(tspec, post, split=True, sign=True)
    bad = harness.tampered_copy(tspec, post, good, index=1)
    try:
        tbls.use_backend("torch", device="cpu")
        tbls.bls_active = True
        verifier = tbls.DeferredVerifier()
        cases = _parity_cases()
        with tbls.deferring(verifier):
            for _, record, _ in cases:
                record()
            marks = [verifier.mark()]
            for block in (good, bad):
                tspec.state_transition(pre.copy(), block, validate_result=True)
                marks.append(verifier.mark())
        bls_torch.reset_stage_seconds()
        verifier.flush()
        yield SimpleNamespace(verifier=verifier, cases=cases, marks=marks, jspec=jspec, tspec=tspec,
                              jstate=jstate, pre=pre, post=post, good=good, bad=bad,
                              seconds=dict(bls_torch.stage_seconds))
    finally:
        tbls.use_reference()
        tbls.bls_active = prev_active
        torch.set_num_threads(threads)


def test_parity_cases_match_the_oracle_semantics(flushed):
    got = {name: res for (name, _, _), res in zip(flushed.cases, flushed.verifier.results)}
    assert got == {name: want for name, _, want in flushed.cases}
    # every stage of the cold path ran in the one flush
    assert all(s > 0 for s in flushed.seconds.values()), flushed.seconds


def test_a_sampled_row_is_decided_identically_by_the_host_oracle(flushed):
    assert host.FastAggregateVerify(PKS[0:3], bytes([7, 0]) * 16,
                                    host.Aggregate([host.Sign(sk, bytes([7, 0]) * 16) for sk in SKS[0:3]]))
    assert not host.Verify(PKS[0], MSG, b"\x00" * 96)


def test_synchronous_calls_match_the_host_oracle():
    """Outside ``deferring`` a check is one call of the device pipeline:
    the facade's Verify goes through ``bls_torch.Verify``, ``verify_batch``
    and ``fast_aggregate_verify_batch``. The backend's scalar
    FastAggregateVerify and AggregateVerify are held here on inputs the
    host checks reject before the device (each costs a pipeline call on
    the CPU), and on the card in ``test_torch_cuda.py``."""
    msgs = [bytes([9, i]) * 16 for i in range(2)]
    sig = host.Sign(SKS[5], msgs[0])
    calls = [
        (lambda b: b.Verify(PKS[5], msgs[0], sig), tbls),
        (lambda b: b.FastAggregateVerify([], msgs[0], sig), bls_torch),
        (lambda b: b.FastAggregateVerify(PKS[:2], msgs[0], b"\x00" * 96), bls_torch),
        (lambda b: b.AggregateVerify(PKS[:2], msgs[:1], sig), bls_torch),
        (lambda b: b.AggregateVerify([], [], sig), bls_torch),
    ]
    want = [call(host) for call, _ in calls]
    assert want == [True, False, False, False, False]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_active = tbls.bls_active
    try:
        tbls.use_backend("torch", device="cpu")
        tbls.bls_active = True
        bls_torch.reset_stage_seconds()
        assert [call(api) for call, api in calls] == want
        assert all(s > 0 for s in bls_torch.stage_seconds.values()), bls_torch.stage_seconds
    finally:
        tbls.use_reference()
        tbls.bls_active = prev_active
        torch.set_num_threads(threads)


def test_batched_pubkey_decode_matches_pk_g1_point():
    """Accept/reject of the device decode equals the host decode's on
    valid, off-curve, out-of-subgroup, infinity and bad-flag encodings."""
    x = 3
    while True:  # an on-curve point outside the subgroup
        y = hf.Fq(x**3 + 4).sqrt()
        if y is not None and not hc.g1_point(hf.Fq(x), y).in_subgroup():
            break
        x += 1
    off_subgroup = hc.g1_to_bytes(hc.g1_point(hf.Fq(x), y))
    x_off = next(v for v in range(5, 100) if hf.Fq(v**3 + 4).sqrt() is None)
    off_curve = bytes([0x80 | (x_off >> 376)]) + (x_off % (1 << 376)).to_bytes(47, "big")
    big_x = bytearray(hf.P.to_bytes(48, "big"))
    big_x[0] |= 0x80
    keys = PKS[:3] + [
        off_subgroup, off_curve, bytes(big_x),
        bytes([0xC0]) + b"\x00" * 47,  # infinity
        bytes([0xC0]) + b"\x00" * 46 + b"\x01",  # malformed infinity
        bytes(PKS[0][:1][0] & 0x7F for _ in range(1)) + PKS[0][1:],  # compression flag cleared
        PKS[0][:47],  # short
    ]
    want = [bls_jax._pk_g1_point(k) is not None for k in keys]
    assert want == [True] * 3 + [False] * 7
    torch.set_num_threads(1)
    try:
        bls_torch.use_device("cpu")
        rows = bls_torch._pubkeys().rows(keys)
        assert [r >= 0 for r in rows] == want
        for k in range(3):
            px, py = bls_torch._pk_affine(keys[k])
            hx, hy = bls_jax._pk_g1_point(keys[k]).affine()
            assert (tower.limbs_to_int(px), tower.limbs_to_int(py)) == (int(hx), int(hy))
    finally:
        bls_torch.clear_caches()


def test_summed_key_signature_equals_aggregate():
    members = [3, 17, 40, 63]
    msg = b"\x5a" * 32
    want = host.Aggregate([host.Sign(i + 1, msg) for i in members])
    assert host.Sign(sum(i + 1 for i in members) % hf.R, msg) == want


def test_block_verifies_and_matches_the_jax_package(flushed, monkeypatch):
    f = flushed
    m0, m1, _ = f.marks
    assert f.verifier.all_true(m0, m1) and m1 - m0 == 2 + len(f.good.message.body.attestations)
    # the runner answers from the same verifier: nothing is sent again
    state = f.pre.copy()
    harness.apply_block_deferred(f.tspec, state, f.good, verifier=f.verifier)
    assert f.tspec.hash_tree_root(state) == f.tspec.hash_tree_root(f.post)
    monkeypatch.setattr(jbls, "bls_active", True)
    jbls.use_reference()
    jstate = f.jstate.copy()
    f.jspec.state_transition(jstate, f.jspec.SignedBeaconBlock.decode_bytes(f.good.encode_bytes()))
    assert f.jspec.hash_tree_root(jstate) == f.tspec.hash_tree_root(state)


def test_tampered_block_is_rejected_by_both(flushed, monkeypatch):
    f = flushed
    _, m1, m2 = f.marks
    rows = f.verifier.results[m1:m2]
    false_keys = [k for k, r in zip(f.verifier.entries[m1:m2], rows) if not r]
    att = f.bad.message.body.attestations[1]
    assert len(false_keys) == 1 and false_keys[0][0] == "fav" and false_keys[0][3] == bytes(att.signature)
    with pytest.raises(AssertionError):
        harness.apply_block_deferred(f.tspec, f.pre.copy(), f.bad, pre_state=f.pre.copy(), verifier=f.verifier)
    monkeypatch.setattr(jbls, "bls_active", True)
    jbls.use_reference()
    with pytest.raises(AssertionError):
        f.jspec.state_transition(f.jstate.copy(), f.jspec.SignedBeaconBlock.decode_bytes(f.bad.encode_bytes()))


def test_torch_backend_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    prev = bls_torch._device
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbls.use_backend("torch")
        assert tbls.use_backend("torch", device="cpu") == "torch"
    finally:
        tbls.use_reference()
        bls_torch._device = prev


def test_planner_floors_put_a_block_in_one_call():
    bls_torch.use_device("cpu")
    rows = [1, 1] + [4] * 4
    from consensus_specs_tpu_torch.sched import plan_flush

    max_rows, min_keys = bls_torch.cold_shape_floors()
    calls = plan_flush(rows, max_rows=max_rows, min_keys=min_keys)
    assert len(calls) == 1
    np.testing.assert_array_equal(sorted(calls[0]), np.arange(len(rows)))
