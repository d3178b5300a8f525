"""Block construction/signing helpers (ref: test/helpers/block.py)."""
from __future__ import annotations

from .constants import is_post_altair, is_post_bellatrix
from .keys import privkeys


def get_proposer_index_maybe(spec, state, slot, proposer_index=None):
    if proposer_index is None:
        if slot == state.slot:
            proposer_index = spec.get_beacon_proposer_index(state)
        else:
            if spec.compute_epoch_at_slot(slot) > spec.compute_epoch_at_slot(state.slot) + 1:
                print("warning: block slot far away, and no proposer index manually given."
                      " Signing block is slow due to transition for proposer index calculation.")
            # Transition a copy to compute the proposer of the future slot
            stub_state = state.copy()
            if stub_state.slot < slot:
                spec.process_slots(stub_state, slot)
            proposer_index = spec.get_beacon_proposer_index(stub_state)
    return proposer_index


def apply_randao_reveal(spec, state, block, proposer_index=None):
    assert state.slot <= block.slot
    proposer_index = get_proposer_index_maybe(spec, state, block.slot, proposer_index)
    privkey = privkeys[proposer_index]
    domain = spec.get_domain(state, spec.DOMAIN_RANDAO, spec.compute_epoch_at_slot(block.slot))
    signing_root = spec.compute_signing_root(
        spec.uint64(spec.compute_epoch_at_slot(block.slot)), domain
    )
    block.body.randao_reveal = spec.bls.Sign(privkey, signing_root)


def apply_sig(spec, state, signed_block, proposer_index=None):
    block = signed_block.message
    proposer_index = get_proposer_index_maybe(spec, state, block.slot, proposer_index)
    privkey = privkeys[proposer_index]
    domain = spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER, spec.compute_epoch_at_slot(block.slot))
    signing_root = spec.compute_signing_root(block, domain)
    signed_block.signature = spec.bls.Sign(privkey, signing_root)


def sign_block(spec, state, block, proposer_index=None):
    signed_block = spec.SignedBeaconBlock(message=block)
    apply_sig(spec, state, signed_block, proposer_index)
    return signed_block


def get_state_and_beacon_parent_root_at_slot(spec, state, slot):
    if slot < state.slot:
        raise Exception("Cannot build blocks for past slots")
    state = state.copy()
    if state.slot < slot:
        spec.process_slots(state, slot)

    previous_block_header = state.latest_block_header.copy()
    if previous_block_header.state_root == spec.Bytes32():
        previous_block_header.state_root = spec.hash_tree_root(state)
    beacon_parent_root = spec.hash_tree_root(previous_block_header)
    return state, beacon_parent_root


def build_empty_block(spec, state, slot=None):
    """Empty block at ``slot`` wired to the current chain tip
    (ref block.py:60-90)."""
    if slot is None:
        slot = state.slot
    state, parent_block_root = get_state_and_beacon_parent_root_at_slot(spec, state, slot)
    empty_block = spec.BeaconBlock()
    empty_block.slot = slot
    empty_block.proposer_index = spec.get_beacon_proposer_index(state)
    empty_block.body.eth1_data.deposit_count = state.eth1_deposit_index
    empty_block.parent_root = parent_block_root

    if is_post_altair(spec):
        empty_block.body.sync_aggregate.sync_committee_signature = spec.G2_POINT_AT_INFINITY
    if is_post_bellatrix(spec):
        # sharding+ drop is_execution_enabled: execution is always on
        # (sharding/beacon-chain.md:551-553)
        always_on = spec.fork in ("sharding", "custody_game", "das")
        if always_on or spec.is_execution_enabled(state, empty_block.body):
            from .execution_payload import build_empty_execution_payload

            empty_block.body.execution_payload = build_empty_execution_payload(spec, state)

    apply_randao_reveal(spec, state, empty_block)
    return empty_block


def build_empty_block_for_next_slot(spec, state):
    return build_empty_block(spec, state, state.slot + 1)
