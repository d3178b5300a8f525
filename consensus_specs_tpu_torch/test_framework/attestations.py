"""Attestation builders + processing runners (ref: test/helpers/
attestations.py)."""
from __future__ import annotations

from .block import build_empty_block_for_next_slot
from .block_processing import state_transition_and_sign_block
from .constants import is_post_altair
from .context import expect_assertion_error
from .keys import aggregate_sign, privkeys
from .state import next_slot


def run_attestation_processing(spec, state, attestation, valid=True):
    """Yield pre/operation/post vector parts around process_attestation
    (ref attestations.py:13-50)."""
    yield "pre", state
    yield "attestation", attestation

    if not valid:
        expect_assertion_error(lambda: spec.process_attestation(state, attestation))
        yield "post", None
        return

    if not is_post_altair(spec):
        current_epoch_count = len(state.current_epoch_attestations)
        previous_epoch_count = len(state.previous_epoch_attestations)

    spec.process_attestation(state, attestation)

    if not is_post_altair(spec):
        if attestation.data.target.epoch == spec.get_current_epoch(state):
            assert len(state.current_epoch_attestations) == current_epoch_count + 1
        else:
            assert len(state.previous_epoch_attestations) == previous_epoch_count + 1

    yield "post", state


def build_attestation_data(spec, state, slot, index, beacon_block_root=None):
    assert state.slot >= slot

    if beacon_block_root is not None:
        block_root = beacon_block_root
    elif slot == state.slot:
        block_root = build_empty_block_for_next_slot(spec, state).parent_root
    else:
        block_root = spec.get_block_root_at_slot(state, slot)

    current_epoch_start_slot = spec.compute_start_slot_at_epoch(spec.get_current_epoch(state))
    if slot < current_epoch_start_slot:
        epoch_boundary_root = spec.get_block_root(state, spec.get_previous_epoch(state))
    elif slot == current_epoch_start_slot:
        epoch_boundary_root = block_root
    else:
        epoch_boundary_root = spec.get_block_root(state, spec.get_current_epoch(state))

    if slot < current_epoch_start_slot:
        source_epoch = state.previous_justified_checkpoint.epoch
        source_root = state.previous_justified_checkpoint.root
    else:
        source_epoch = state.current_justified_checkpoint.epoch
        source_root = state.current_justified_checkpoint.root

    return spec.AttestationData(
        slot=slot,
        index=index,
        beacon_block_root=block_root,
        source=spec.Checkpoint(epoch=source_epoch, root=source_root),
        target=spec.Checkpoint(epoch=spec.compute_epoch_at_slot(slot), root=epoch_boundary_root),
    )


def get_attestation_signing_root(spec, state, attestation_data):
    domain = spec.get_domain(state, spec.DOMAIN_BEACON_ATTESTER, attestation_data.target.epoch)
    return spec.compute_signing_root(attestation_data, domain)


def get_attestation_signature(spec, state, attestation_data, privkey):
    return spec.bls.Sign(privkey, get_attestation_signing_root(spec, state, attestation_data))


def sign_aggregate_attestation(spec, state, attestation_data, participants):
    # one Sign under the summed key — bit-identical to aggregating
    # per-participant signatures (see keys.aggregate_sign)
    signing_root = get_attestation_signing_root(spec, state, attestation_data)
    return aggregate_sign([privkeys[i] for i in participants], signing_root)


def sign_indexed_attestation(spec, state, indexed_attestation):
    participants = indexed_attestation.attesting_indices
    data = indexed_attestation.data
    indexed_attestation.signature = sign_aggregate_attestation(spec, state, data, participants)


def sign_attestation(spec, state, attestation):
    participants = spec.get_attesting_indices(state, attestation.data, attestation.aggregation_bits)
    attestation.signature = sign_aggregate_attestation(spec, state, attestation.data, participants)


def fill_aggregate_attestation(spec, state, attestation, signed=False, filter_participant_set=None):
    """Set all (or a filtered subset of) committee bits; optionally sign
    (ref attestations.py:130-160)."""
    beacon_committee = spec.get_beacon_committee(state, attestation.data.slot, attestation.data.index)
    participants = set(beacon_committee)
    if filter_participant_set is not None:
        participants = filter_participant_set(participants)
    for i in range(len(beacon_committee)):
        attestation.aggregation_bits[i] = beacon_committee[i] in participants
    if signed and len(participants) > 0:
        sign_attestation(spec, state, attestation)


def get_valid_attestation(spec, state, slot=None, index=None, filter_participant_set=None, signed=False):
    """A valid (optionally signed) attestation for (slot, index); committee
    bits all set unless filtered (ref attestations.py:88-128)."""
    if slot is None:
        slot = state.slot
    if index is None:
        index = 0

    attestation_data = build_attestation_data(spec, state, slot=slot, index=index)
    beacon_committee = spec.get_beacon_committee(state, attestation_data.slot, attestation_data.index)

    committee_size = len(beacon_committee)
    aggregation_bits = spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE]([0] * committee_size)
    attestation = spec.Attestation(aggregation_bits=aggregation_bits, data=attestation_data)
    fill_aggregate_attestation(
        spec, state, attestation, signed=signed, filter_participant_set=filter_participant_set
    )
    return attestation


def get_valid_attestation_at_slot(state, spec, slot_to_attest, participation_fn=None):
    """One attestation per committee at the slot (generator over committee
    indices, ref attestations.py:190-230)."""
    committees_per_slot = spec.get_committee_count_per_slot(
        state, spec.compute_epoch_at_slot(slot_to_attest)
    )
    for index in range(committees_per_slot):
        def participants_filter(comm):
            if participation_fn is None:
                return comm
            return participation_fn(spec.compute_epoch_at_slot(slot_to_attest), slot_to_attest, index, comm)

        yield get_valid_attestation(
            spec,
            state,
            slot_to_attest,
            index=spec.CommitteeIndex(index),
            signed=True,
            filter_participant_set=participants_filter,
        )


def state_transition_with_full_block(spec, state, fill_cur_epoch, fill_prev_epoch,
                                     participation_fn=None, sync_aggregate=None):
    """Build + apply a block carrying a full slot's attestations
    (ref attestations.py:232-280)."""
    block = build_empty_block_for_next_slot(spec, state)
    if fill_cur_epoch and state.slot >= spec.MIN_ATTESTATION_INCLUSION_DELAY:
        slot_to_attest = state.slot - spec.MIN_ATTESTATION_INCLUSION_DELAY + 1
        if slot_to_attest >= spec.compute_start_slot_at_epoch(spec.get_current_epoch(state)):
            for attestation in get_valid_attestation_at_slot(state, spec, slot_to_attest, participation_fn):
                block.body.attestations.append(attestation)
    if fill_prev_epoch and state.slot >= spec.SLOTS_PER_EPOCH:
        slot_to_attest = state.slot - spec.SLOTS_PER_EPOCH + 1
        for attestation in get_valid_attestation_at_slot(state, spec, slot_to_attest, participation_fn):
            block.body.attestations.append(attestation)
    if sync_aggregate is not None:
        block.body.sync_aggregate = sync_aggregate
    return state_transition_and_sign_block(spec, state, block)


def state_transition_with_epoch_sweep_block(spec, state, fill_cur_epoch, fill_prev_epoch):
    """Build + apply a block sweeping attestations over the attestable
    slots of the current epoch so far (and the still-includable tail of
    the previous epoch) — the many-slot analog of
    state_transition_with_full_block, used to justify an epoch with a
    single late block. The epoch's start slot itself is left out of the
    current-epoch sweep (ref attestations.py:280-313 behavior)."""
    block = build_empty_block_for_next_slot(spec, state)
    epoch_start = spec.compute_start_slot_at_epoch(spec.get_current_epoch(state))
    if fill_cur_epoch:
        # epoch_start+1 .. the newest slot the block's inclusion delay
        # still admits
        target = int(block.slot) - int(spec.MIN_ATTESTATION_INCLUSION_DELAY)
        while target > epoch_start:
            for attestation in get_valid_attestation_at_slot(state, spec, target):
                block.body.attestations.append(attestation)
            target -= 1
    if fill_prev_epoch:
        # the previous epoch's tail still inside the inclusion window
        target = epoch_start - 1
        floor = max(int(block.slot) - int(spec.SLOTS_PER_EPOCH), 0)
        while int(target) >= floor:
            for attestation in get_valid_attestation_at_slot(state, spec, target):
                block.body.attestations.append(attestation)
            target -= 1
    return state_transition_and_sign_block(spec, state, block)


def next_slots_with_attestations(spec, state, slot_count, fill_cur_epoch, fill_prev_epoch,
                                 participation_fn=None):
    post_state = state.copy()
    signed_blocks = []
    for _ in range(slot_count):
        signed_block = state_transition_with_full_block(
            spec, post_state, fill_cur_epoch, fill_prev_epoch, participation_fn
        )
        signed_blocks.append(signed_block)
    return state, signed_blocks, post_state


def next_epoch_with_attestations(spec, state, fill_cur_epoch, fill_prev_epoch, participation_fn=None):
    assert state.slot % spec.SLOTS_PER_EPOCH == 0
    return next_slots_with_attestations(
        spec, state, spec.SLOTS_PER_EPOCH, fill_cur_epoch, fill_prev_epoch, participation_fn
    )


def prepare_state_with_attestations(spec, state, participation_fn=None):
    """Advance until previous-epoch attestations cover a full epoch; mutates
    ``state`` in place (ref attestations.py:359-374)."""
    # Go to start of next epoch to ensure attestations in current epoch count
    start_slot = state.slot
    start_epoch = spec.get_current_epoch(state)
    next_epoch_start_slot = spec.compute_start_slot_at_epoch(start_epoch + 1)
    attestations = []
    for _ in range(next_epoch_start_slot + spec.MIN_ATTESTATION_INCLUSION_DELAY - start_slot):
        if state.slot < next_epoch_start_slot:
            for index in range(spec.get_committee_count_per_slot(state, spec.get_current_epoch(state))):
                def temp_participants_filter(comm):
                    if participation_fn is None:
                        return comm
                    return participation_fn(spec.get_current_epoch(state), state.slot, index, comm)

                attestation = get_valid_attestation(
                    spec, state, index=index, signed=True, filter_participant_set=temp_participants_filter
                )
                if any(attestation.aggregation_bits):
                    attestations.append(attestation)
        next_slot(spec, state)

        # Add to state when inclusion delay has passed
        for attestation in list(attestations):
            if state.slot >= attestation.data.slot + spec.MIN_ATTESTATION_INCLUSION_DELAY:
                spec.process_attestation(state, attestation)
                attestations.remove(attestation)

    if hasattr(state, "previous_epoch_attestations"):
        # phase0: every slot of the (now previous) epoch must be attested
        attested_slots = {int(a.data.slot) for a in state.previous_epoch_attestations}
        expected = {
            int(spec.compute_start_slot_at_epoch(start_epoch) + i)
            for i in range(spec.SLOTS_PER_EPOCH)
        }
        assert attested_slots == expected, (sorted(attested_slots), sorted(expected))
    else:
        # altair+: participation flags landed for the previous epoch
        assert any(int(f) != 0 for f in state.previous_epoch_participation)
    return state
