"""State progression helpers (ref: test/helpers/state.py)."""
from __future__ import annotations



def get_balance(state, index):
    return state.balances[index]


def next_slot(spec, state):
    spec.process_slots(state, state.slot + 1)


def next_slots(spec, state, slots):
    if slots > 0:
        spec.process_slots(state, state.slot + slots)


def transition_to(spec, state, slot):
    assert state.slot <= slot
    for _ in range(1000):
        if state.slot < slot:
            spec.process_slots(state, slot)
        if state.slot == slot:
            return
    raise AssertionError(f"could not reach slot {slot}")


def transition_to_slot_via_block(spec, state, slot):
    """Advance using a (signed) empty block landing exactly at ``slot``."""
    from .block_processing import state_transition_and_sign_block
    from .block import build_empty_block

    assert state.slot < slot
    return state_transition_and_sign_block(spec, state, build_empty_block(spec, state, slot))


def next_epoch(spec, state):
    slot = state.slot + spec.SLOTS_PER_EPOCH - (state.slot % spec.SLOTS_PER_EPOCH)
    if slot > state.slot:
        spec.process_slots(state, slot)


def next_epoch_via_block(spec, state):
    """Advance one epoch with a block at the boundary slot."""
    from .block_processing import state_transition_and_sign_block
    from .block import build_empty_block

    slot = state.slot + spec.SLOTS_PER_EPOCH - (state.slot % spec.SLOTS_PER_EPOCH)
    block = build_empty_block(spec, state, slot)
    return state_transition_and_sign_block(spec, state, block)


def transition_to_valid_shard_slot(spec, state):
    """Advance into the first slot of epoch 1: the epoch transition's
    reset_pending_shard_work has then seeded SHARD_WORK_PENDING lists for
    the current epoch's (slot, shard) pairs, so process_shard_header
    accepts headers for slot SLOTS_PER_EPOCH (0 < header.slot <= state.slot)."""
    transition_to(spec, state, spec.SLOTS_PER_EPOCH + 1)


def state_transition_and_sign_block(spec, state, block, expect_fail=False):
    # Back-compat alias; the real implementation lives in block_processing
    from .block_processing import state_transition_and_sign_block as impl

    return impl(spec, state, block, expect_fail=expect_fail)


def has_active_balance_differential(spec, state) -> bool:
    """Active balance != total balance (ref state.py helper for randomized
    scenario sanity)."""
    active_balance = spec.get_total_active_balance(state)
    total_balance = spec.Gwei(sum(int(b) for b in state.balances))
    return active_balance // spec.EFFECTIVE_BALANCE_INCREMENT != total_balance // spec.EFFECTIVE_BALANCE_INCREMENT


def get_state_root(spec, state, slot):
    assert slot < state.slot <= slot + spec.SLOTS_PER_HISTORICAL_ROOT
    return state.state_roots[slot % spec.SLOTS_PER_HISTORICAL_ROOT]


def payload_state_transition(spec, store, block):  # bellatrix fork-choice helper hook
    pass


def cause_effective_balance_decrease_below_threshold(spec, state, index):
    """Set a validator's effective balance below the hysteresis threshold."""
    state.validators[index].effective_balance = spec.config.EJECTION_BALANCE
