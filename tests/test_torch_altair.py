"""The port's altair slice against the JAX package: the harness's altair
genesis equals the JAX test framework's, a signed minimal altair block with
a real sync aggregate (and a sync seat repeated) goes through the port's
BLS facade in one deferred flush on the torch backend (the kernels' plain
versions on the CPU) and the engine's batched attestations, and reaches the
JAX package's post-state; a copy of it whose sync aggregate signs another
root is rejected, that row alone. The sync aggregate's pubkey lookup takes
the first index of a repeated registry key, as the spec's ``list.index``
does."""
import numpy as np
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


@pytest.fixture(scope="module")
def specs():
    return jbuild("altair", "minimal"), tbuild("altair", "minimal")


@pytest.fixture(scope="module")
def genesis_pair(specs):
    jspec, tspec = specs
    jstate = _prepare_state(default_balances, default_activation_threshold, jspec)
    return jstate, harness.genesis(tspec, len(jstate.validators))


def test_altair_genesis_equals_the_jax_test_framework(genesis_pair):
    jstate, tstate = genesis_pair
    assert tstate.encode_bytes() == jstate.encode_bytes()
    assert tstate.current_sync_committee == tstate.next_sync_committee


def test_participation_is_drawn_from_the_seed(specs, genesis_pair):
    _, tspec = specs
    a, b, c = (genesis_pair[1].copy() for _ in range(3))
    harness.draw_participation(tspec, a, seed=3)
    harness.draw_participation(tspec, b, seed=3)
    harness.draw_participation(tspec, c, seed=4)
    cols = [np.array(list(s.previous_epoch_participation), dtype=np.uint8) for s in (a, b, c)]
    assert np.array_equal(cols[0], cols[1]) and not np.array_equal(cols[0], cols[2])
    assert set(np.unique(cols[0])) <= set(range(8)) and (cols[0] & 2).any()


@pytest.fixture(scope="module")
def flushed(specs, genesis_pair):
    """One signed block at slot 1 (attestations of slot 0 in halves, the
    sync aggregate with a key in two participating seats) and its copy with the
    sync aggregate signing another root, both recorded in one deferred
    verifier and flushed as ONE call on the torch backend on the CPU (the
    planner's key floor raised to the sync row's bucket: on the CPU each
    call costs the plain versions' chains, whatever its rows)."""
    jspec, tspec = specs
    threads, prev_active = torch.get_num_threads(), tbls.bls_active
    torch.set_num_threads(1)
    pre = genesis_pair[1].copy()
    slot1 = pre.copy()
    tspec.process_slots(slot1, 1)
    bits = list(harness.sync_aggregate_for_slot(tspec, slot1, seed=9, sign=False).sync_committee_bits)
    on = [i for i, bit in enumerate(bits) if bit]
    committee = pre.current_sync_committee
    committee.pubkeys[on[1]] = committee.pubkeys[on[0]]  # one validator in two participating seats
    post = pre.copy()
    good = harness.next_block(tspec, post, split=True, sign=True, seed=9)
    bad = harness.tampered_sync_copy(tspec, post, good, seed=9)
    floors = bls_torch.cold_shape_floors
    try:
        tbls.use_backend("torch", device="cpu")
        bls_torch.cold_shape_floors = lambda: (256, int(tspec.SYNC_COMMITTEE_SIZE))
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
        yield dict(jspec=jspec, tspec=tspec, pre=pre, post=post, good=good, bad=bad, verifier=verifier,
                   marks=marks, calls=calls)
    finally:
        bls_torch.cold_shape_floors = floors
        engine.use_direct_attestations()
        tbls.use_reference()
        tbls.bls_active = prev_active
        torch.set_num_threads(threads)


def test_block_with_a_sync_aggregate_verifies_and_matches_the_jax_package(flushed, monkeypatch):
    f = flushed
    m0, m1, _ = f["marks"]
    good = f["good"].message
    bits = list(good.body.sync_aggregate.sync_committee_bits)
    keys = f["verifier"].entries[m0:m1]
    sync_rows = [k for k in keys if k[0] == "fav" and len(k[1]) == sum(bits)]
    assert f["calls"] == [len(set(f["verifier"].entries))]  # one backend call for both blocks
    assert f["verifier"].all_true(m0, m1) and m1 - m0 == 3 + len(good.body.attestations)
    assert len(sync_rows) == 1 and len(set(sync_rows[0][1])) == sum(bits) - 1
    state = f["pre"].copy()
    harness.apply_block_deferred(f["tspec"], state, f["good"], verifier=f["verifier"])
    assert f["tspec"].hash_tree_root(state) == f["tspec"].hash_tree_root(f["post"])
    jspec = f["jspec"]
    monkeypatch.setattr(jbls, "bls_active", False)
    jstate = jspec.BeaconState.decode_bytes(f["pre"].encode_bytes())
    jspec.state_transition(jstate, jspec.SignedBeaconBlock.decode_bytes(f["good"].encode_bytes()))
    assert jspec.hash_tree_root(jstate) == f["tspec"].hash_tree_root(state)
    assert jstate.encode_bytes() == state.encode_bytes()


def test_a_sync_aggregate_over_another_root_is_rejected_alone(flushed):
    f = flushed
    _, m1, m2 = f["marks"]
    rows = list(zip(f["verifier"].entries[m1:m2], f["verifier"].results[m1:m2]))
    rejected = [k for k, ok in rows if not ok]
    signature = bytes(f["bad"].message.body.sync_aggregate.sync_committee_signature)
    assert len(rejected) == 1 and rejected[0][0] == "fav" and rejected[0][3] == signature
    with pytest.raises(AssertionError):
        harness.apply_block_deferred(f["tspec"], f["pre"].copy(), f["bad"], pre_state=f["pre"].copy(),
                                     verifier=f["verifier"])


@pytest.mark.parametrize("where", ["before", "after"])
def test_sync_reward_goes_to_the_first_index_of_a_repeated_key(specs, genesis_pair, where, monkeypatch):
    """A committee member's key repeated at a row before (or after) its
    own: the port's map and the JAX package's ``list.index`` credit the
    same validator, the first, so the post-states agree."""
    jspec, tspec = specs
    monkeypatch.setattr(jbls, "bls_active", False)
    monkeypatch.setattr(tbls, "bls_active", False)
    state = genesis_pair[1].copy()
    tspec.process_slots(state, 1)
    first = harness._first_indices(state)
    members = sorted({first[bytes(pk)] for pk in state.current_sync_committee.pubkeys})
    free = [i for i in range(len(state.validators))
            if i not in members and i != tspec.get_beacon_proposer_index(state)]
    pairs = [(m, o) for m in members for o in free if (o < m) == (where == "before")]
    member, other = pairs[len(pairs) // 2]
    state.validators[other].pubkey = state.validators[member].pubkey
    jstate = jspec.BeaconState.decode_bytes(state.encode_bytes())
    aggregate = harness.sync_aggregate_for_slot(tspec, state, seed=1, sign=False)
    tspec.process_sync_aggregate(state, aggregate)
    jspec.process_sync_aggregate(jstate, jspec.SyncAggregate.decode_bytes(aggregate.encode_bytes()))
    assert state.encode_bytes() == jstate.encode_bytes()
    moved = [i for i in (member, other) if state.balances[i] != genesis_pair[1].balances[i]]
    assert moved == [min(member, other)]
