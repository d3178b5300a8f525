"""Bellatrix (Merge) spec source (delta over altair).

Covers specs/bellatrix/{beacon-chain,fork,fork-choice,validator}.md,
fork_choice/safe-block.md and sync/optimistic.md at v1.1.10: execution
payloads, the ExecutionEngine process boundary (Noop-stubbed exactly like
the reference test harness, setup.py:514-546), terminal-PoW-block
transition validation, safe-block helpers, and optimistic sync.
"""
from dataclasses import dataclass as _dataclass
from typing import Dict as _Dict, Optional as _Optional, Sequence as _Sequence, Set as _Set


# ---------------------------------------------------------------------------
# Custom types (bellatrix/beacon-chain.md:60-80)
# ---------------------------------------------------------------------------

Transaction = ByteList[MAX_BYTES_PER_TRANSACTION]  # noqa: F821


class ExecutionAddress(Bytes20):  # noqa: F821
    pass


class PayloadId(Bytes8):  # noqa: F821
    pass


# ---------------------------------------------------------------------------
# Containers (bellatrix/beacon-chain.md:104-206)
# ---------------------------------------------------------------------------

class ExecutionPayload(Container):  # noqa: F821
    # Execution block header fields
    parent_hash: Hash32  # noqa: F821
    fee_recipient: ExecutionAddress
    state_root: Bytes32  # noqa: F821
    receipts_root: Bytes32  # noqa: F821
    logs_bloom: ByteVector[BYTES_PER_LOGS_BLOOM]  # noqa: F821
    prev_randao: Bytes32  # noqa: F821
    block_number: uint64  # noqa: F821
    gas_limit: uint64  # noqa: F821
    gas_used: uint64  # noqa: F821
    timestamp: uint64  # noqa: F821
    extra_data: ByteList[MAX_EXTRA_DATA_BYTES]  # noqa: F821
    base_fee_per_gas: uint256  # noqa: F821
    # Extra payload fields
    block_hash: Hash32  # noqa: F821
    transactions: List[Transaction, MAX_TRANSACTIONS_PER_PAYLOAD]  # noqa: F821


class ExecutionPayloadHeader(Container):  # noqa: F821
    parent_hash: Hash32  # noqa: F821
    fee_recipient: ExecutionAddress
    state_root: Bytes32  # noqa: F821
    receipts_root: Bytes32  # noqa: F821
    logs_bloom: ByteVector[BYTES_PER_LOGS_BLOOM]  # noqa: F821
    prev_randao: Bytes32  # noqa: F821
    block_number: uint64  # noqa: F821
    gas_limit: uint64  # noqa: F821
    gas_used: uint64  # noqa: F821
    timestamp: uint64  # noqa: F821
    extra_data: ByteList[MAX_EXTRA_DATA_BYTES]  # noqa: F821
    base_fee_per_gas: uint256  # noqa: F821
    block_hash: Hash32  # noqa: F821
    transactions_root: Root  # noqa: F821


class BeaconBlockBody(Container):  # noqa: F821
    randao_reveal: BLSSignature  # noqa: F821
    eth1_data: Eth1Data  # noqa: F821
    graffiti: Bytes32  # noqa: F821
    proposer_slashings: List[ProposerSlashing, MAX_PROPOSER_SLASHINGS]  # noqa: F821
    attester_slashings: List[AttesterSlashing, MAX_ATTESTER_SLASHINGS]  # noqa: F821
    attestations: List[Attestation, MAX_ATTESTATIONS]  # noqa: F821
    deposits: List[Deposit, MAX_DEPOSITS]  # noqa: F821
    voluntary_exits: List[SignedVoluntaryExit, MAX_VOLUNTARY_EXITS]  # noqa: F821
    sync_aggregate: SyncAggregate  # noqa: F821
    execution_payload: ExecutionPayload  # [New in Bellatrix]


class BeaconBlock(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    proposer_index: ValidatorIndex  # noqa: F821
    parent_root: Root  # noqa: F821
    state_root: Root  # noqa: F821
    body: BeaconBlockBody


class SignedBeaconBlock(Container):  # noqa: F821
    message: BeaconBlock
    signature: BLSSignature  # noqa: F821


class BeaconState(Container):  # noqa: F821
    genesis_time: uint64  # noqa: F821
    genesis_validators_root: Root  # noqa: F821
    slot: Slot  # noqa: F821
    fork: Fork  # noqa: F821
    latest_block_header: BeaconBlockHeader  # noqa: F821
    block_roots: Vector[Root, SLOTS_PER_HISTORICAL_ROOT]  # noqa: F821
    state_roots: Vector[Root, SLOTS_PER_HISTORICAL_ROOT]  # noqa: F821
    historical_roots: List[Root, HISTORICAL_ROOTS_LIMIT]  # noqa: F821
    eth1_data: Eth1Data  # noqa: F821
    eth1_data_votes: List[Eth1Data, EPOCHS_PER_ETH1_VOTING_PERIOD * SLOTS_PER_EPOCH]  # noqa: F821
    eth1_deposit_index: uint64  # noqa: F821
    validators: List[Validator, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    balances: List[Gwei, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    randao_mixes: Vector[Bytes32, EPOCHS_PER_HISTORICAL_VECTOR]  # noqa: F821
    slashings: Vector[Gwei, EPOCHS_PER_SLASHINGS_VECTOR]  # noqa: F821
    previous_epoch_participation: List[ParticipationFlags, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    current_epoch_participation: List[ParticipationFlags, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    justification_bits: Bitvector[JUSTIFICATION_BITS_LENGTH]  # noqa: F821
    previous_justified_checkpoint: Checkpoint  # noqa: F821
    current_justified_checkpoint: Checkpoint  # noqa: F821
    finalized_checkpoint: Checkpoint  # noqa: F821
    inactivity_scores: List[uint64, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    current_sync_committee: SyncCommittee  # noqa: F821
    next_sync_committee: SyncCommittee  # noqa: F821
    # Execution [New in Bellatrix]
    latest_execution_payload_header: ExecutionPayloadHeader


# ---------------------------------------------------------------------------
# Predicates & misc (bellatrix/beacon-chain.md:212-243)
# ---------------------------------------------------------------------------

def is_merge_transition_complete(state: "BeaconState") -> bool:
    return state.latest_execution_payload_header != ExecutionPayloadHeader()


def is_merge_transition_block(state: "BeaconState", body: BeaconBlockBody) -> bool:
    return not is_merge_transition_complete(state) and body.execution_payload != ExecutionPayload()


def is_execution_enabled(state: "BeaconState", body: BeaconBlockBody) -> bool:
    return is_merge_transition_block(state, body) or is_merge_transition_complete(state)


def compute_timestamp_at_slot(state: "BeaconState", slot) -> "uint64":  # noqa: F821
    slots_since_genesis = slot - GENESIS_SLOT  # noqa: F821
    return uint64(state.genesis_time + slots_since_genesis * config.SECONDS_PER_SLOT)  # noqa: F821


# ---------------------------------------------------------------------------
# Bellatrix-quotient overrides (bellatrix/beacon-chain.md:247-299,380-396)
# ---------------------------------------------------------------------------

def get_inactivity_penalty_deltas(state: "BeaconState"):
    rewards = [Gwei(0) for _ in range(len(state.validators))]  # noqa: F821
    penalties = [Gwei(0) for _ in range(len(state.validators))]  # noqa: F821
    previous_epoch = get_previous_epoch(state)  # noqa: F821
    matching_target_indices = get_unslashed_participating_indices(  # noqa: F821
        state, TIMELY_TARGET_FLAG_INDEX, previous_epoch  # noqa: F821
    )
    penalty_denominator = config.INACTIVITY_SCORE_BIAS * INACTIVITY_PENALTY_QUOTIENT_BELLATRIX  # noqa: F821
    for index in get_eligible_validator_indices(state):  # noqa: F821
        if index not in matching_target_indices:
            penalty_numerator = state.validators[index].effective_balance * state.inactivity_scores[index]
            penalties[index] += Gwei(penalty_numerator // penalty_denominator)  # noqa: F821
    return rewards, penalties


def slash_validator(state: "BeaconState", slashed_index, whistleblower_index=None) -> None:
    epoch = get_current_epoch(state)  # noqa: F821
    initiate_validator_exit(state, slashed_index)  # noqa: F821
    validator = state.validators[slashed_index]
    validator.slashed = True
    validator.withdrawable_epoch = max(validator.withdrawable_epoch, Epoch(epoch + EPOCHS_PER_SLASHINGS_VECTOR))  # noqa: F821
    state.slashings[epoch % EPOCHS_PER_SLASHINGS_VECTOR] += validator.effective_balance  # noqa: F821
    slashing_penalty = validator.effective_balance // MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX  # noqa: F821
    decrease_balance(state, slashed_index, slashing_penalty)  # noqa: F821

    proposer_index = get_beacon_proposer_index(state)  # noqa: F821
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = Gwei(validator.effective_balance // WHISTLEBLOWER_REWARD_QUOTIENT)  # noqa: F821
    proposer_reward = Gwei(whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR)  # noqa: F821
    increase_balance(state, proposer_index, proposer_reward)  # noqa: F821
    increase_balance(state, whistleblower_index, Gwei(whistleblower_reward - proposer_reward))  # noqa: F821


def process_slashings(state: "BeaconState") -> None:
    epoch = get_current_epoch(state)  # noqa: F821
    total_balance = get_total_active_balance(state)  # noqa: F821
    adjusted_total_slashing_balance = min(
        sum(int(s) for s in state.slashings) * PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX,  # noqa: F821
        total_balance,
    )
    increment = EFFECTIVE_BALANCE_INCREMENT  # noqa: F821
    for index, validator in enumerate(state.validators):
        if validator.slashed and epoch + EPOCHS_PER_SLASHINGS_VECTOR // 2 == validator.withdrawable_epoch:  # noqa: F821
            penalty_numerator = validator.effective_balance // increment * adjusted_total_slashing_balance
            penalty = penalty_numerator // total_balance * increment
            decrease_balance(state, ValidatorIndex(index), Gwei(penalty))  # noqa: F821


# ---------------------------------------------------------------------------
# Execution engine boundary (bellatrix/beacon-chain.md:305-325; stubbed
# exactly like the reference test harness, setup.py:530-546)
# ---------------------------------------------------------------------------

class ExecutionEngine:
    """Protocol: the process boundary to the execution client."""

    def notify_new_payload(self, execution_payload: ExecutionPayload) -> bool:
        raise NotImplementedError

    def notify_forkchoice_updated(self, head_block_hash, safe_block_hash,
                                  finalized_block_hash, payload_attributes):
        raise NotImplementedError

    def get_payload(self, payload_id) -> ExecutionPayload:
        raise NotImplementedError


class NoopExecutionEngine(ExecutionEngine):
    """Always-valid stub EL client (ref setup.py:530-546) — how the
    multi-process system is tested without a cluster."""

    def notify_new_payload(self, execution_payload: ExecutionPayload) -> bool:
        return True

    def notify_forkchoice_updated(self, head_block_hash, safe_block_hash,
                                  finalized_block_hash, payload_attributes):
        pass

    def get_payload(self, payload_id) -> ExecutionPayload:
        raise NotImplementedError("no default block production")


EXECUTION_ENGINE = NoopExecutionEngine()


# ---------------------------------------------------------------------------
# Block processing (bellatrix/beacon-chain.md:331-374)
# ---------------------------------------------------------------------------

def process_block(state: "BeaconState", block: BeaconBlock) -> None:
    process_block_header(state, block)  # noqa: F821
    if is_execution_enabled(state, block.body):
        process_execution_payload(state, block.body.execution_payload, EXECUTION_ENGINE)  # [New in Bellatrix]
    process_randao(state, block.body)  # noqa: F821
    process_eth1_data(state, block.body)  # noqa: F821
    process_operations(state, block.body)  # noqa: F821
    process_sync_aggregate(state, block.body.sync_aggregate)  # noqa: F821


def block_process_steps():
    def _maybe_payload(state, block):
        if is_execution_enabled(state, block.body):
            process_execution_payload(state, block.body.execution_payload, EXECUTION_ENGINE)

    return [
        ("process_block_header", lambda state, block: process_block_header(state, block)),  # noqa: F821
        ("process_execution_payload", _maybe_payload),
        ("process_randao", lambda state, block: process_randao(state, block.body)),  # noqa: F821
        ("process_eth1_data", lambda state, block: process_eth1_data(state, block.body)),  # noqa: F821
        ("process_operations", lambda state, block: process_operations(state, block.body)),  # noqa: F821
        ("process_sync_aggregate", lambda state, block: process_sync_aggregate(state, block.body.sync_aggregate)),  # noqa: F821
    ]


def process_execution_payload(state: "BeaconState", payload: ExecutionPayload,
                              execution_engine: ExecutionEngine) -> None:
    # Parent-hash chain continuity (post-transition only)
    if is_merge_transition_complete(state):
        assert payload.parent_hash == state.latest_execution_payload_header.block_hash
    # CL-supplied randomness and timestamp must match
    assert payload.prev_randao == get_randao_mix(state, get_current_epoch(state))  # noqa: F821
    assert payload.timestamp == compute_timestamp_at_slot(state, state.slot)
    # EL-side validity — the process boundary
    assert execution_engine.notify_new_payload(payload)
    state.latest_execution_payload_header = ExecutionPayloadHeader(
        parent_hash=payload.parent_hash,
        fee_recipient=payload.fee_recipient,
        state_root=payload.state_root,
        receipts_root=payload.receipts_root,
        logs_bloom=payload.logs_bloom,
        prev_randao=payload.prev_randao,
        block_number=payload.block_number,
        gas_limit=payload.gas_limit,
        gas_used=payload.gas_used,
        timestamp=payload.timestamp,
        extra_data=payload.extra_data,
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=payload.block_hash,
        transactions_root=hash_tree_root(payload.transactions),  # noqa: F821
    )


# ---------------------------------------------------------------------------
# Testing genesis (bellatrix/beacon-chain.md:408-460)
# ---------------------------------------------------------------------------

def initialize_beacon_state_from_eth1(eth1_block_hash, eth1_timestamp, deposits,
                                      execution_payload_header=None) -> "BeaconState":
    if execution_payload_header is None:
        execution_payload_header = ExecutionPayloadHeader()
    fork = Fork(  # noqa: F821
        previous_version=config.BELLATRIX_FORK_VERSION,  # noqa: F821
        current_version=config.BELLATRIX_FORK_VERSION,  # noqa: F821
        epoch=GENESIS_EPOCH,  # noqa: F821
    )
    state = BeaconState(
        genesis_time=eth1_timestamp + config.GENESIS_DELAY,  # noqa: F821
        fork=fork,
        eth1_data=Eth1Data(block_hash=eth1_block_hash, deposit_count=uint64(len(deposits))),  # noqa: F821
        latest_block_header=BeaconBlockHeader(body_root=hash_tree_root(BeaconBlockBody())),  # noqa: F821
        randao_mixes=[eth1_block_hash] * EPOCHS_PER_HISTORICAL_VECTOR,  # noqa: F821
    )

    leaves = [deposit.data for deposit in deposits]
    for index, deposit in enumerate(deposits):
        deposit_data_list = List[DepositData, 2**DEPOSIT_CONTRACT_TREE_DEPTH](leaves[: index + 1])  # noqa: F821
        state.eth1_data.deposit_root = hash_tree_root(deposit_data_list)  # noqa: F821
        process_deposit(state, deposit)  # noqa: F821

    for index, validator in enumerate(state.validators):
        balance = state.balances[index]
        validator.effective_balance = min(
            balance - balance % EFFECTIVE_BALANCE_INCREMENT, MAX_EFFECTIVE_BALANCE  # noqa: F821
        )
        if validator.effective_balance == MAX_EFFECTIVE_BALANCE:  # noqa: F821
            validator.activation_eligibility_epoch = GENESIS_EPOCH  # noqa: F821
            validator.activation_epoch = GENESIS_EPOCH  # noqa: F821

    state.genesis_validators_root = hash_tree_root(state.validators)  # noqa: F821

    state.current_sync_committee = get_next_sync_committee(state)  # noqa: F821
    state.next_sync_committee = get_next_sync_committee(state)  # noqa: F821

    # [New in Bellatrix] seed the execution header (non-default => merged genesis)
    state.latest_execution_payload_header = execution_payload_header

    return state


# ---------------------------------------------------------------------------
# Fork upgrade (bellatrix/fork.md:50-97)
# ---------------------------------------------------------------------------

def upgrade_to_bellatrix(pre) -> "BeaconState":
    epoch = compute_epoch_at_slot(pre.slot)  # noqa: F821
    post = BeaconState(
        genesis_time=pre.genesis_time,
        genesis_validators_root=pre.genesis_validators_root,
        slot=pre.slot,
        fork=Fork(  # noqa: F821
            previous_version=pre.fork.current_version,
            current_version=config.BELLATRIX_FORK_VERSION,  # noqa: F821
            epoch=epoch,
        ),
        latest_block_header=pre.latest_block_header,
        block_roots=pre.block_roots,
        state_roots=pre.state_roots,
        historical_roots=pre.historical_roots,
        eth1_data=pre.eth1_data,
        eth1_data_votes=pre.eth1_data_votes,
        eth1_deposit_index=pre.eth1_deposit_index,
        validators=pre.validators,
        balances=pre.balances,
        randao_mixes=pre.randao_mixes,
        slashings=pre.slashings,
        previous_epoch_participation=pre.previous_epoch_participation,
        current_epoch_participation=pre.current_epoch_participation,
        justification_bits=pre.justification_bits,
        previous_justified_checkpoint=pre.previous_justified_checkpoint,
        current_justified_checkpoint=pre.current_justified_checkpoint,
        finalized_checkpoint=pre.finalized_checkpoint,
        inactivity_scores=pre.inactivity_scores,
        current_sync_committee=pre.current_sync_committee,
        next_sync_committee=pre.next_sync_committee,
        latest_execution_payload_header=ExecutionPayloadHeader(),
    )
    return post


# ---------------------------------------------------------------------------
# Fork choice additions (bellatrix/fork-choice.md)
# ---------------------------------------------------------------------------

@_dataclass
class PayloadAttributes:
    timestamp: "uint64"  # noqa: F821
    prev_randao: "Bytes32"  # noqa: F821
    suggested_fee_recipient: ExecutionAddress


class PowBlock(Container):  # noqa: F821
    block_hash: Hash32  # noqa: F821
    parent_hash: Hash32  # noqa: F821
    total_difficulty: uint256  # noqa: F821


def get_pow_block(block_hash) -> _Optional[PowBlock]:
    """Test-infra stub for the PoW chain view (ref setup.py:518-519);
    tests monkeypatch this."""
    return PowBlock(block_hash=block_hash, parent_hash=Hash32(), total_difficulty=uint256(0))  # noqa: F821


def is_valid_terminal_pow_block(block: PowBlock, parent: PowBlock) -> bool:
    is_total_difficulty_reached = block.total_difficulty >= config.TERMINAL_TOTAL_DIFFICULTY  # noqa: F821
    is_parent_total_difficulty_valid = parent.total_difficulty < config.TERMINAL_TOTAL_DIFFICULTY  # noqa: F821
    return is_total_difficulty_reached and is_parent_total_difficulty_valid


def validate_merge_block(block: BeaconBlock) -> None:
    """Validate the transition block's terminal PoW parent
    (bellatrix/fork-choice.md:125)."""
    if config.TERMINAL_BLOCK_HASH != Hash32():  # noqa: F821
        # Terminal block hash override
        assert compute_epoch_at_slot(block.slot) >= config.TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH  # noqa: F821
        assert block.body.execution_payload.parent_hash == Hash32(config.TERMINAL_BLOCK_HASH)  # noqa: F821
        return

    pow_block = get_pow_block(block.body.execution_payload.parent_hash)
    assert pow_block is not None
    pow_parent = get_pow_block(pow_block.parent_hash)
    assert pow_parent is not None
    assert is_valid_terminal_pow_block(pow_block, pow_parent)


def on_block(store: "Store", signed_block: SignedBeaconBlock) -> None:  # noqa: F821
    """phase0 on_block + transition-block validation
    (bellatrix/fork-choice.md:156)."""
    block = signed_block.message
    assert block.parent_root in store.block_states
    pre_state = copy(store.block_states[block.parent_root])  # noqa: F821
    assert get_current_slot(store) >= block.slot  # noqa: F821

    finalized_slot = compute_start_slot_at_epoch(store.finalized_checkpoint.epoch)  # noqa: F821
    assert block.slot > finalized_slot
    assert get_ancestor(store, block.parent_root, finalized_slot) == store.finalized_checkpoint.root  # noqa: F821

    state = pre_state.copy()
    state_transition(state, signed_block, True)  # noqa: F821

    # [New in Bellatrix]
    if is_merge_transition_block(pre_state, block.body):
        validate_merge_block(block)

    block_root = Root(hash_tree_root(block))  # noqa: F821
    store.blocks[block_root] = block
    store.block_states[block_root] = state

    time_into_slot = (store.time - store.genesis_time) % config.SECONDS_PER_SLOT  # noqa: F821
    is_before_attesting_interval = time_into_slot < config.SECONDS_PER_SLOT // INTERVALS_PER_SLOT  # noqa: F821
    if get_current_slot(store) == block.slot and is_before_attesting_interval:  # noqa: F821
        store.proposer_boost_root = block_root

    if state.current_justified_checkpoint.epoch > store.justified_checkpoint.epoch:
        if state.current_justified_checkpoint.epoch > store.best_justified_checkpoint.epoch:
            store.best_justified_checkpoint = state.current_justified_checkpoint
        if should_update_justified_checkpoint(store, state.current_justified_checkpoint):  # noqa: F821
            store.justified_checkpoint = state.current_justified_checkpoint

    if state.finalized_checkpoint.epoch > store.finalized_checkpoint.epoch:
        store.finalized_checkpoint = state.finalized_checkpoint
        store.justified_checkpoint = state.current_justified_checkpoint


# Safe block helpers (fork_choice/safe-block.md)

def get_safe_beacon_block_root(store: "Store") -> "Root":  # noqa: F821
    # Most recent justified block as a stopgap
    return store.justified_checkpoint.root


def get_safe_execution_payload_hash(store: "Store") -> "Hash32":  # noqa: F821
    safe_block_root = get_safe_beacon_block_root(store)
    safe_block = store.blocks[safe_block_root]
    # Hash32() until a payload is justified
    if compute_epoch_at_slot(safe_block.slot) >= config.BELLATRIX_FORK_EPOCH:  # noqa: F821
        return safe_block.body.execution_payload.block_hash
    return Hash32()  # noqa: F821


# ---------------------------------------------------------------------------
# Optimistic sync (sync/optimistic.md)
# ---------------------------------------------------------------------------

@_dataclass
class OptimisticStore:
    optimistic_roots: _Set["Root"]  # noqa: F821
    head_block_root: "Root"  # noqa: F821
    blocks: _Dict["Root", "BeaconBlock"]  # noqa: F821


def is_optimistic(opt_store: OptimisticStore, block: "BeaconBlock") -> bool:  # noqa: F821
    return hash_tree_root(block) in opt_store.optimistic_roots  # noqa: F821


def latest_verified_ancestor(opt_store: OptimisticStore, block: "BeaconBlock") -> "BeaconBlock":  # noqa: F821
    # Only call on blocks with at least one verified ancestor
    while True:
        if not is_optimistic(opt_store, block) or block.parent_root == Root():  # noqa: F821
            return block
        block = opt_store.blocks[block.parent_root]


def is_execution_block(block: "BeaconBlock") -> bool:  # noqa: F821
    return block.body.execution_payload != ExecutionPayload()


def is_optimistic_candidate_block(opt_store: OptimisticStore, current_slot, block: "BeaconBlock") -> bool:  # noqa: F821
    if is_execution_block(opt_store.blocks[block.parent_root]):
        return True
    if block.slot + SAFE_SLOTS_TO_IMPORT_OPTIMISTICALLY <= current_slot:  # noqa: F821
        return True
    return False


SAFE_SLOTS_TO_IMPORT_OPTIMISTICALLY = 128  # sync/optimistic.md preset


# ---------------------------------------------------------------------------
# Validator guide (bellatrix/validator.md)
# ---------------------------------------------------------------------------

def get_pow_block_at_terminal_total_difficulty(pow_chain) -> _Optional[PowBlock]:
    # pow_chain: Dict[Hash32, PowBlock] of all PoW blocks
    for block in pow_chain.values():
        block_reached_ttd = block.total_difficulty >= config.TERMINAL_TOTAL_DIFFICULTY  # noqa: F821
        if block_reached_ttd:
            # Genesis block: reaching TTD alone qualifies
            if block.parent_hash == Hash32():  # noqa: F821
                return block
            parent = pow_chain[block.parent_hash]
            parent_reached_ttd = parent.total_difficulty >= config.TERMINAL_TOTAL_DIFFICULTY  # noqa: F821
            if not parent_reached_ttd:
                return block
    return None


def get_terminal_pow_block(pow_chain) -> _Optional[PowBlock]:
    if config.TERMINAL_BLOCK_HASH != Hash32():  # noqa: F821
        # Terminal block hash override takes precedence over TTD
        if Hash32(config.TERMINAL_BLOCK_HASH) in pow_chain:  # noqa: F821
            return pow_chain[Hash32(config.TERMINAL_BLOCK_HASH)]  # noqa: F821
        return None
    return get_pow_block_at_terminal_total_difficulty(pow_chain)


def prepare_execution_payload(state: "BeaconState", pow_chain, safe_block_hash,
                              finalized_block_hash, suggested_fee_recipient,
                              execution_engine: ExecutionEngine) -> _Optional[PayloadId]:
    if not is_merge_transition_complete(state):
        is_terminal_block_hash_set = config.TERMINAL_BLOCK_HASH != Hash32()  # noqa: F821
        is_activation_epoch_reached = (
            get_current_epoch(state) >= config.TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH  # noqa: F821
        )
        if is_terminal_block_hash_set and not is_activation_epoch_reached:
            return None
        terminal_pow_block = get_terminal_pow_block(pow_chain)
        if terminal_pow_block is None:
            return None  # pre-merge, no payload yet
        parent_hash = terminal_pow_block.block_hash
    else:
        parent_hash = state.latest_execution_payload_header.block_hash

    payload_attributes = PayloadAttributes(
        timestamp=compute_timestamp_at_slot(state, state.slot),
        prev_randao=get_randao_mix(state, get_current_epoch(state)),  # noqa: F821
        suggested_fee_recipient=suggested_fee_recipient,
    )
    return execution_engine.notify_forkchoice_updated(
        parent_hash, safe_block_hash, finalized_block_hash, payload_attributes
    )


def get_execution_payload(payload_id: _Optional[PayloadId],
                          execution_engine: ExecutionEngine) -> ExecutionPayload:
    if payload_id is None:
        # Pre-merge empty payload
        return ExecutionPayload()
    return execution_engine.get_payload(payload_id)
