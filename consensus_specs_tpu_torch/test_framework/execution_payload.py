"""Execution payload test helpers (ref: test/helpers/execution_payload.py)."""
from __future__ import annotations


def build_empty_execution_payload(spec, state, randao_mix=None):
    """Payload for an empty execution block chained on the latest header."""
    latest = state.latest_execution_payload_header
    timestamp = spec.compute_timestamp_at_slot(state, state.slot)
    empty_txs = spec.List[spec.Transaction, spec.MAX_TRANSACTIONS_PER_PAYLOAD]()

    if randao_mix is None:
        randao_mix = spec.get_randao_mix(state, spec.get_current_epoch(state))

    payload = spec.ExecutionPayload(
        parent_hash=latest.block_hash,
        fee_recipient=spec.ExecutionAddress(),
        state_root=latest.state_root,  # no change to the execution state
        receipts_root=b"no receipts here" + b"\x00" * 16,  # mock receipts
        logs_bloom=spec.ByteVector[spec.BYTES_PER_LOGS_BLOOM](),  # all zeroes
        prev_randao=randao_mix,
        block_number=latest.block_number + 1,
        gas_limit=latest.gas_limit,  # retain same limit
        gas_used=0,  # empty block, 0 gas
        timestamp=timestamp,
        extra_data=spec.ByteList[spec.MAX_EXTRA_DATA_BYTES](),
        base_fee_per_gas=latest.base_fee_per_gas,  # retain same base_fee
        transactions=empty_txs,
    )
    if hasattr(spec, "get_expected_withdrawals"):  # capella+
        # copy each withdrawal: this SSZ library assigns composites by
        # reference, and the payload must be independent of the state's
        # withdrawals_queue (a tampered payload test would otherwise
        # tamper the queue too)
        payload.withdrawals = [wd.copy() for wd in spec.get_expected_withdrawals(state)]
    payload.block_hash = compute_el_block_hash(spec, payload)
    return payload


def compute_el_block_hash(spec, payload):
    """Mock EL block hash (no RLP/keccak in scope — same convention as the
    reference test helpers)."""
    return spec.Hash32(spec.hash(payload.hash_tree_root() + b"FAKE RLP HASH"))


def get_execution_payload_header(spec, execution_payload):
    payload_header = spec.ExecutionPayloadHeader(
        parent_hash=execution_payload.parent_hash,
        fee_recipient=execution_payload.fee_recipient,
        state_root=execution_payload.state_root,
        receipts_root=execution_payload.receipts_root,
        logs_bloom=execution_payload.logs_bloom,
        prev_randao=execution_payload.prev_randao,
        block_number=execution_payload.block_number,
        gas_limit=execution_payload.gas_limit,
        gas_used=execution_payload.gas_used,
        timestamp=execution_payload.timestamp,
        extra_data=execution_payload.extra_data,
        base_fee_per_gas=execution_payload.base_fee_per_gas,
        block_hash=execution_payload.block_hash,
        transactions_root=spec.hash_tree_root(execution_payload.transactions),
    )
    if hasattr(execution_payload, "withdrawals"):  # capella+
        payload_header.withdrawals_root = spec.hash_tree_root(execution_payload.withdrawals)
    return payload_header


def build_state_with_execution_payload_header(spec, state, execution_payload_header):
    pre_state = state.copy()
    pre_state.latest_execution_payload_header = execution_payload_header
    return pre_state


def build_state_with_incomplete_transition(spec, state):
    return build_state_with_execution_payload_header(spec, state, spec.ExecutionPayloadHeader())


def build_state_with_complete_transition(spec, state):
    pre_state_payload = build_empty_execution_payload(spec, state)
    payload_header = get_execution_payload_header(spec, pre_state_payload)
    return build_state_with_execution_payload_header(spec, state, payload_header)


def run_execution_payload_processing(spec, state, execution_payload, valid=True, execution_valid=True):
    """Yield pre/operation/post around process_execution_payload
    (ref helpers/execution_payload.py runner)."""
    from .context import expect_assertion_error

    yield "pre", state
    yield "execution", {"execution_valid": execution_valid}
    yield "execution_payload", execution_payload

    class TestEngine(spec.NoopExecutionEngine):
        def notify_new_payload(self, payload) -> bool:
            return execution_valid

    if not valid:
        expect_assertion_error(
            lambda: spec.process_execution_payload(state, execution_payload, TestEngine())
        )
        yield "post", None
        return

    spec.process_execution_payload(state, execution_payload, TestEngine())
    yield "post", state

    assert state.latest_execution_payload_header.block_hash == execution_payload.block_hash
    assert state.latest_execution_payload_header.transactions_root == spec.hash_tree_root(
        execution_payload.transactions
    )
