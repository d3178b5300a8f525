"""The port's phase0 slice against the JAX package: the same genesis and
the same blocks (with attestations, across an epoch boundary) through
``state_transition`` in both packages, each with its device hasher
installed (the port's on ``device="cpu"``, i.e. the kernels' plain
versions). Routing thresholds are lowered in both so that every seam runs
at this size. Roots must be equal after every slot, and the final states
byte-identical."""
import pytest
import torch

from consensus_specs_tpu.crypto import bls as jbls
from consensus_specs_tpu.ops import sha256 as jdev
from consensus_specs_tpu.specs import build_spec as jbuild
from consensus_specs_tpu.ssz import hashing as jhashing
from consensus_specs_tpu.test_framework.attestations import state_transition_with_full_block
from consensus_specs_tpu.test_framework.context import (
    _prepare_state,
    default_activation_threshold,
    default_balances,
)
from consensus_specs_tpu_torch import harness, interop
from consensus_specs_tpu_torch.crypto import bls as tbls
from consensus_specs_tpu_torch.ops import sha256 as tdev
from consensus_specs_tpu_torch.specs import build_spec as tbuild
from consensus_specs_tpu_torch.ssz import hashing as thashing


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel are not crowded out by torch's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

LOW_THRESHOLDS = {
    "DEVICE_MIN_BLOCKS": 16,
    "FUSED_ROOT_MIN_CHUNKS": 16,
    "TREE_DEVICE_MIN_CHUNKS": 16,
    "ITEM_ROOTS_MIN_ITEMS": 16,
}


@pytest.fixture
def device_hashers(monkeypatch):
    monkeypatch.setattr(jbls, "bls_active", False)
    monkeypatch.setattr(tbls, "bls_active", False)
    jdev.use_device_hasher(calibrate=False)
    tdev.use_device_hasher(device="cpu", calibrate=False)
    for mod in (jhashing, thashing):
        for name, value in LOW_THRESHOLDS.items():
            monkeypatch.setattr(mod, name, value)
    tdev.reset_counters()
    yield
    jdev.use_host_hasher()
    tdev.use_host_hasher()


def test_phase0_transition_matches_jax(device_hashers):
    jspec, tspec = jbuild("phase0", "minimal"), tbuild("phase0", "minimal")
    jstate = _prepare_state(default_balances, default_activation_threshold, jspec)
    tstate = interop.state_from_reference(jstate.encode_bytes(), "phase0", "minimal")
    assert tspec.hash_tree_root(tstate) == jspec.hash_tree_root(jstate)
    n_attestations = 0
    for _ in range(int(jspec.SLOTS_PER_EPOCH) + 2):
        signed = state_transition_with_full_block(jspec, jstate, True, True)
        n_attestations += len(signed.message.body.attestations)
        tspec.state_transition(tstate, interop.block_from_reference(signed.encode_bytes(), "phase0", "minimal"))
        assert tspec.hash_tree_root(tstate) == jspec.hash_tree_root(jstate), int(tstate.slot)
    assert tspec.get_current_epoch(tstate) == 1 and n_attestations > 0
    assert tstate.encode_bytes() == jstate.encode_bytes()
    launched = tdev.counters()["launches"]
    assert thashing.backend_name() == "torch-cpu" and launched == {"sha256_blocks": 0, "sha256_raw_blocks": 0}


def test_harness_matches_jax_genesis_and_blocks(device_hashers):
    jspec, tspec = jbuild("phase0", "minimal"), tbuild("phase0", "minimal")
    jstate = _prepare_state(default_balances, default_activation_threshold, jspec)
    tstate = harness.genesis(tspec, len(jstate.validators))
    assert tstate.encode_bytes() == jstate.encode_bytes()
    for _ in range(2):
        signed = harness.next_block(tspec, tstate)
        assert len(signed.message.body.attestations) == int(tspec.get_committee_count_per_slot(tstate, 0))
        jspec.state_transition(jstate, jspec.SignedBeaconBlock.decode_bytes(signed.encode_bytes()))
        assert jspec.hash_tree_root(jstate) == tspec.hash_tree_root(tstate)


def test_mainnet_empty_state_root():
    """65,536 randao_mixes chunks go through the fused-root seam."""
    jspec, tspec = jbuild("phase0", "mainnet"), tbuild("phase0", "mainnet")
    want = jspec.hash_tree_root(jspec.BeaconState())
    tdev.use_device_hasher(device="cpu", calibrate=False)
    try:
        assert tspec.hash_tree_root(tspec.BeaconState()) == want
    finally:
        tdev.use_host_hasher()


def test_active_indices_memo_follows_the_registry():
    """The port's phase0 memoizes get_active_validator_indices on
    (registry root, epoch): a registry change must give a fresh answer."""
    jspec, tspec = jbuild("phase0", "minimal"), tbuild("phase0", "minimal")
    jstate = _prepare_state(default_balances, default_activation_threshold, jspec)
    tstate = interop.state_from_reference(jstate.encode_bytes(), "phase0", "minimal")
    assert tspec.get_active_validator_indices(tstate, 0) == jspec.get_active_validator_indices(jstate, 0)
    for spec, state in ((jspec, jstate), (tspec, tstate)):
        state.validators[3].exit_epoch = 0
        state.validators[5].activation_epoch = 2
    for epoch in (0, 2):
        got = tspec.get_active_validator_indices(tstate, epoch)
        assert got == jspec.get_active_validator_indices(jstate, epoch)
        assert (3 in got, 5 in got) == (False, epoch == 2)
