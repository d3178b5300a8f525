"""Block transition runners (ref: test/helpers/state.py:60-120 and
helpers/block.py signing flow)."""
from __future__ import annotations

from .block import sign_block
from .context import expect_assertion_error


def transition_unsigned_block(spec, state, block):
    """process_slots + process_block, without signature/state-root checks."""
    assert state.slot < block.slot
    spec.process_slots(state, block.slot)
    spec.process_block(state, block)
    return block


def state_transition_and_sign_block(spec, state, block, expect_fail=False):
    """Apply the block to ``state``, fill in its state root, and return the
    signed block (ref state.py:60-90). With ``expect_fail`` the transition
    must raise, state is left at the pre-block slot, and the SIGNED
    invalid block is still returned — expected-failure vectors must ship
    the block a replaying client is supposed to reject (returning None
    here emitted block-less invalid sanity vectors; caught by
    tools/replay_vectors)."""
    if expect_fail:
        expect_assertion_error(lambda: transition_unsigned_block(spec, state.copy(), block))
        return sign_block(spec, state, block)
    transition_unsigned_block(spec, state, block)
    block.state_root = spec.hash_tree_root(state)
    return sign_block(spec, state, block)


def run_block_processing_to(spec, state, block, process_name: str):
    """Advance state through the per-block sub-transitions *before*
    ``process_name``, then return — so a test can run exactly one
    sub-transition against a correctly-staged state. The order comes from
    the spec's own block_process_steps() table, so fork deltas that insert
    steps (execution payload, withdrawals, sync aggregate) stage correctly
    (ref helpers/block_processing.py)."""
    if state.slot < block.slot:
        spec.process_slots(state, block.slot)

    names = [name for name, _ in spec.block_process_steps()]
    assert process_name in names, f"{process_name} not in {names}"
    for name, apply in spec.block_process_steps():
        if name == process_name:
            break
        apply(state, block)
    return state
