"""process_attestation operation cases
(ref: test/phase0/block_processing/test_process_attestation.py).

The port's copy of the JAX package's ``tests/spec/test_operations_attestation.py``:
the ``operations`` runner's ``attestation`` handler turns each ``test_*``
function into one vector case named after it. The module's name has no
``test_`` prefix, so pytest never collects it."""
from consensus_specs_tpu_torch.test_framework.attestations import (
    get_valid_attestation,
    run_attestation_processing,
    sign_attestation,
)
from consensus_specs_tpu_torch.test_framework.context import (
    always_bls,
    expect_assertion_error,
    spec_state_test,
    with_all_phases,
)
from consensus_specs_tpu_torch.test_framework.state import next_slot, next_slots, next_epoch, transition_to


@with_all_phases
@spec_state_test
def test_success(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_success_previous_epoch(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    next_epoch(spec, state)
    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_attestation_signature(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_empty_participants_zeroes_sig(spec, state):
    attestation = get_valid_attestation(spec, state, filter_participant_set=lambda comm: set())
    attestation.signature = spec.BLSSignature(b"\x00" * 96)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_empty_participants_seemingly_valid_sig(spec, state):
    attestation = get_valid_attestation(spec, state, filter_participant_set=lambda comm: set())
    # G2 point at infinity aggregate over zero keys
    attestation.signature = spec.BLSSignature(b"\xc0" + b"\x00" * 95)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_before_inclusion_delay(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    # do not increment slot to allow inclusion
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_after_epoch_slots(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    # increment beyond latest inclusion slot
    transition_to(spec, state, state.slot + spec.SLOTS_PER_EPOCH + 1)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_old_source_epoch(spec, state):
    next_slots(spec, state, spec.SLOTS_PER_EPOCH * 5)
    state.finalized_checkpoint.epoch = 2
    state.previous_justified_checkpoint.epoch = 3
    state.current_justified_checkpoint.epoch = 4

    attestation = get_valid_attestation(spec, state, slot=(spec.SLOTS_PER_EPOCH * 3) + 1)
    # test logic sanity check: the attestation's source epoch is the
    # previous-justified checkpoint's; now make it too old
    assert attestation.data.source.epoch == state.previous_justified_checkpoint.epoch
    attestation.data.source.epoch -= 1
    sign_attestation(spec, state, attestation)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_wrong_index_for_committee_signature(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    attestation.data.index += 1
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_index(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    # off by one (with respect to valid range) committee index
    attestation.data.index = spec.get_committee_count_per_slot(state, spec.get_current_epoch(state))
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_mismatched_target_and_slot(spec, state):
    next_epoch(spec, state)
    next_epoch(spec, state)

    attestation = get_valid_attestation(spec, state, slot=state.slot - spec.SLOTS_PER_EPOCH)
    attestation.data.slot = attestation.data.slot + spec.SLOTS_PER_EPOCH
    sign_attestation(spec, state, attestation)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_old_target_epoch(spec, state):
    assert spec.MIN_ATTESTATION_INCLUSION_DELAY < spec.SLOTS_PER_EPOCH * 2
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slots(spec, state, spec.SLOTS_PER_EPOCH * 2)  # target epoch will be too old
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_future_target_epoch(spec, state):
    attestation = get_valid_attestation(spec, state)
    participants = spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    )
    attestation.data.target.epoch = spec.get_current_epoch(state) + 1  # future epoch
    # manually add signature for correct participants
    attestation.signature = spec.BLSSignature(b"\x00" * 96)
    sign_attestation(spec, state, attestation)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_new_source_epoch(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    attestation.data.source.epoch += 1
    sign_attestation(spec, state, attestation)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_current_source_root(spec, state):
    next_slots(spec, state, spec.SLOTS_PER_EPOCH * 5)
    state.finalized_checkpoint.epoch = 2
    state.previous_justified_checkpoint = spec.Checkpoint(epoch=3, root=b"\x01" * 32)
    state.current_justified_checkpoint = spec.Checkpoint(epoch=4, root=b"\x32" * 32)

    attestation = get_valid_attestation(spec, state, slot=state.slot - 1)
    # attestation with the wrong source root
    attestation.data.source.root = b"\x09" * 32
    sign_attestation(spec, state, attestation)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_bad_source_root(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    attestation.data.source.root = b"\x42" * 32
    sign_attestation(spec, state, attestation)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_too_many_aggregation_bits(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    # one too many bits — BEFORE the part yields: the vector must carry
    # the malformed bitlist or a replaying client sees a valid attestation
    # with no post state (caught by tools/replay_vectors)
    attestation.aggregation_bits._bits.append(False)

    yield "pre", state
    yield "attestation", attestation
    expect_assertion_error(lambda: spec.process_attestation(state, attestation))
    yield "post", None


@with_all_phases
@spec_state_test
def test_too_few_aggregation_bits(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    sign_attestation(spec, state, attestation)
    # drop a bit BEFORE the part yields (see test_too_many_aggregation_bits)
    attestation.aggregation_bits._bits.pop()

    yield "pre", state
    yield "attestation", attestation
    expect_assertion_error(lambda: spec.process_attestation(state, attestation))
    yield "post", None


@with_all_phases
@spec_state_test
def test_correct_attestation_included_at_max_inclusion_slot(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slots(spec, state, spec.SLOTS_PER_EPOCH)
    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_incorrect_head_attestation(spec, state):
    attestation = get_valid_attestation(spec, state, signed=False)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    attestation.data.beacon_block_root = b"\x42" * 32
    sign_attestation(spec, state, attestation)
    # LMD vote is not validated by process_attestation: still valid
    yield from run_attestation_processing(spec, state, attestation)
