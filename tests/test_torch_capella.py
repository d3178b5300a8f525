"""The port's bellatrix and capella slice against the JAX package: the
harness's genesis equals the JAX test framework's on both forks, the port's
fork upgrades encode as the JAX package's, and a signed minimal capella
block (an execution payload carrying withdrawals, BLS-to-execution changes,
a sync aggregate and attestations in halves) goes through the port's BLS
facade in one deferred flush on the torch backend (the kernels' plain
versions on the CPU) and the engine, and reaches the JAX package's
post-state; a copy of it with one change signed over another root is
rejected, that row alone; a payload whose withdrawals differ from the queue
is refused by both packages."""
import pytest
import torch

from consensus_specs_tpu.crypto import bls as jbls
from consensus_specs_tpu.specs import build_spec as jbuild
from consensus_specs_tpu.test_framework.context import (
    _prepare_state,
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu_torch import engine, harness
from consensus_specs_tpu_torch.crypto import bls as tbls
from consensus_specs_tpu_torch.ops import bls_torch
from consensus_specs_tpu_torch.specs import build_spec as tbuild
from consensus_specs_tpu_torch.test_framework.execution_payload import build_empty_execution_payload

WITHDRAWING = 4  # validators whose full withdrawals the block's payload carries


@pytest.fixture(autouse=True)
def _bls_off(monkeypatch):
    monkeypatch.setattr(jbls, "bls_active", False)
    monkeypatch.setattr(tbls, "bls_active", False)


@pytest.mark.parametrize("fork", ["bellatrix", "capella"])
def test_genesis_equals_the_jax_test_framework(fork):
    jspec, tspec = jbuild(fork, "minimal"), tbuild(fork, "minimal")
    jstate = _prepare_state(default_balances, default_activation_threshold, jspec)
    tstate = harness.genesis(tspec, len(jstate.validators))
    assert tstate.encode_bytes() == jstate.encode_bytes()


def test_fork_upgrades_encode_as_the_jax_package():
    """altair -> bellatrix -> capella on a state that has run a few slots,
    through each package's own upgrade functions."""
    altair = tbuild("altair", "minimal")
    state = harness.genesis(altair, 64)
    altair.process_slots(state, 3)
    jb, tb = jbuild("bellatrix", "minimal"), tbuild("bellatrix", "minimal")
    jc, tc = jbuild("capella", "minimal"), tbuild("capella", "minimal")
    jpre = jbuild("altair", "minimal").BeaconState.decode_bytes(state.encode_bytes())
    jpost, tpost = jc.upgrade_to_capella(jb.upgrade_to_bellatrix(jpre)), tc.upgrade_to_capella(tb.upgrade_to_bellatrix(state))
    assert tb.upgrade_to_bellatrix(state).encode_bytes() == jb.upgrade_to_bellatrix(jpre).encode_bytes()
    assert tpost.encode_bytes() == jpost.encode_bytes()
    assert tpost.fork.current_version == tc.config.CAPELLA_FORK_VERSION
    assert all(v.fully_withdrawn_epoch == tc.FAR_FUTURE_EPOCH for v in tpost.validators)


@pytest.fixture(scope="module")
def chain():
    """A post-merge minimal capella chain with a withdrawal backlog swept at
    epoch 0 -> 1, at slot 8: the pre-state of the block at slot 9."""
    spec = tbuild("capella", "minimal")
    state = harness.genesis(spec, 64, post_merge=True)
    withdrawing = harness.draw_withdrawing(spec, state, seed=9, count=WITHDRAWING, epoch=0)
    spec.process_slots(state, 8)
    assert [int(w.amount) > 0 for w in state.withdrawals_queue] == [True] * WITHDRAWING
    assert all(state.validators[i].fully_withdrawn_epoch == 0 for i in withdrawing)
    return spec, state


@pytest.fixture(scope="module")
def flushed(chain):
    """One signed block at slot 9 (attestations of slot 8 in halves, a sync
    aggregate, a payload with the backlog's withdrawals, 2 BLS-to-execution
    changes) and its copy with one change signed over another root, both
    recorded in one deferred verifier and flushed as ONE call on the torch
    backend on the CPU (the planner's key floor raised to the sync row's
    bucket: on the CPU each call costs the plain versions' chains, whatever
    its rows)."""
    tspec, pre = chain
    threads, prev_active = torch.get_num_threads(), tbls.bls_active
    torch.set_num_threads(1)
    post = pre.copy()
    good = harness.next_block(tspec, post, split=True, sign=True, seed=9, changes=2)
    bad = harness.tampered_change_copy(tspec, post, good, index=1)
    floors = bls_torch.cold_shape_floors
    try:
        tbls.use_backend("torch", device="cpu")
        bls_torch.cold_shape_floors = lambda: (256, int(tspec.SYNC_COMMITTEE_SIZE))
        engine.use_vectorized_epoch()
        engine.use_batched_attestations()
        tbls.bls_active = True
        verifier = tbls.DeferredVerifier()
        marks = [verifier.mark()]
        with tbls.deferring(verifier):
            for block in (good, bad):
                tspec.state_transition(pre.copy(), block, validate_result=True)
                marks.append(verifier.mark())
        calls = []
        cold = bls_torch.fast_aggregate_verify_batch_cold
        bls_torch.fast_aggregate_verify_batch_cold = lambda *a: calls.append(len(a[0])) or cold(*a)
        try:
            verifier.flush()
        finally:
            bls_torch.fast_aggregate_verify_batch_cold = cold
        yield dict(tspec=tspec, pre=pre, post=post, good=good, bad=bad, verifier=verifier, marks=marks, calls=calls)
    finally:
        bls_torch.cold_shape_floors = floors
        engine.use_interpreted_epoch()
        engine.use_direct_attestations()
        tbls.use_reference()
        tbls.bls_active = prev_active
        torch.set_num_threads(threads)


def test_capella_block_verifies_in_one_flush_and_matches_the_jax_package(flushed):
    f = flushed
    m0, m1, _ = f["marks"]
    body = f["good"].message.body
    assert len(body.execution_payload.withdrawals) == WITHDRAWING and len(body.bls_to_execution_changes) == 2
    changes = {(bytes(c.message.from_bls_pubkey), bytes(c.signature)) for c in body.bls_to_execution_changes}
    keys = f["verifier"].entries[m0:m1]
    assert {(k[1], k[3]) for k in keys if k[0] == "v"} >= changes  # each change is one Verify row
    assert f["calls"] == [len(set(f["verifier"].entries))]  # one backend call for both blocks
    assert f["verifier"].all_true(m0, m1) and m1 - m0 == 3 + 2 + len(body.attestations)
    state = f["pre"].copy()
    tbls.bls_active = True
    harness.apply_block_deferred(f["tspec"], state, f["good"], verifier=f["verifier"])
    tbls.bls_active = False
    assert f["tspec"].hash_tree_root(state) == f["tspec"].hash_tree_root(f["post"])
    jspec = jbuild("capella", "minimal")
    jstate = jspec.BeaconState.decode_bytes(f["pre"].encode_bytes())
    jspec.state_transition(jstate, jspec.SignedBeaconBlock.decode_bytes(f["good"].encode_bytes()))
    assert jstate.encode_bytes() == state.encode_bytes()
    assert len(state.withdrawals_queue) == 0 and int(state.withdrawal_index) == WITHDRAWING
    for c in body.bls_to_execution_changes:
        creds = bytes(state.validators[c.message.validator_index].withdrawal_credentials)
        assert creds == bytes(f["tspec"].ETH1_ADDRESS_WITHDRAWAL_PREFIX) + bytes(11) + bytes(c.message.to_execution_address)


def test_a_change_over_another_root_is_rejected_alone(flushed):
    f = flushed
    _, m1, m2 = f["marks"]
    rows = list(zip(f["verifier"].entries[m1:m2], f["verifier"].results[m1:m2]))
    rejected = [k for k, ok in rows if not ok]
    change = f["bad"].message.body.bls_to_execution_changes[1]
    assert len(rejected) == 1 and rejected[0][0] == "v"
    assert rejected[0][1] == bytes(change.message.from_bls_pubkey) and rejected[0][3] == bytes(change.signature)
    tbls.bls_active = True
    with pytest.raises(AssertionError):
        harness.apply_block_deferred(f["tspec"], f["pre"].copy(), f["bad"], pre_state=f["pre"].copy(),
                                     verifier=f["verifier"])


@pytest.mark.parametrize("fault", ["amount", "missing"])
def test_a_payload_whose_withdrawals_differ_from_the_queue_is_refused(chain, fault):
    tspec, pre = chain
    jspec = jbuild("capella", "minimal")
    state = pre.copy()
    tspec.process_slots(state, 9)
    payload = build_empty_execution_payload(tspec, state)
    assert len(payload.withdrawals) == WITHDRAWING
    if fault == "amount":
        payload.withdrawals[0].amount += 1
    else:
        payload.withdrawals = list(payload.withdrawals)[1:]
    jstate = jspec.BeaconState.decode_bytes(state.encode_bytes())
    jpayload = jspec.ExecutionPayload.decode_bytes(payload.encode_bytes())
    with pytest.raises(AssertionError):
        tspec.process_withdrawals(state, payload)
    with pytest.raises(AssertionError):
        jspec.process_withdrawals(jstate, jpayload)
    good = build_empty_execution_payload(tspec, state)  # the payload held copies: the queue is as it was
    assert list(good.withdrawals) == list(state.withdrawals_queue) != list(payload.withdrawals)
    tspec.process_withdrawals(state, good)  # the queue's own withdrawals pass, on both
    jspec.process_withdrawals(jstate, jspec.ExecutionPayload.decode_bytes(good.encode_bytes()))
    assert state.encode_bytes() == jstate.encode_bytes() and len(state.withdrawals_queue) == 0
