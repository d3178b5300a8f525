"""Capella spec source (delta over bellatrix), v1.1.10 draft.

Covers specs/capella/{beacon-chain,fork,validator}.md: withdrawals
(queue-based, as in the draft at this version), BLSToExecutionChange
credential rotation, and the capella fork upgrade.
"""


# ---------------------------------------------------------------------------
# Custom types & constants (capella/beacon-chain.md:55-95)
# ---------------------------------------------------------------------------

class WithdrawalIndex(uint64):  # noqa: F821
    pass


DOMAIN_BLS_TO_EXECUTION_CHANGE = DomainType(b"\x0a\x00\x00\x00")  # noqa: F821


# ---------------------------------------------------------------------------
# New containers (capella/beacon-chain.md:99-121)
# ---------------------------------------------------------------------------

class Withdrawal(Container):  # noqa: F821
    index: WithdrawalIndex
    address: ExecutionAddress  # noqa: F821
    amount: Gwei  # noqa: F821


class BLSToExecutionChange(Container):  # noqa: F821
    validator_index: ValidatorIndex  # noqa: F821
    from_bls_pubkey: BLSPubkey  # noqa: F821
    to_execution_address: ExecutionAddress  # noqa: F821


class SignedBLSToExecutionChange(Container):  # noqa: F821
    message: BLSToExecutionChange
    signature: BLSSignature  # noqa: F821


# ---------------------------------------------------------------------------
# Extended containers (capella/beacon-chain.md:128-250)
# ---------------------------------------------------------------------------

class ExecutionPayload(Container):  # noqa: F821
    parent_hash: Hash32  # noqa: F821
    fee_recipient: ExecutionAddress  # noqa: F821
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
    transactions: List[Transaction, MAX_TRANSACTIONS_PER_PAYLOAD]  # noqa: F821
    withdrawals: List[Withdrawal, MAX_WITHDRAWALS_PER_PAYLOAD]  # [New in Capella]  # noqa: F821


class ExecutionPayloadHeader(Container):  # noqa: F821
    parent_hash: Hash32  # noqa: F821
    fee_recipient: ExecutionAddress  # noqa: F821
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
    withdrawals_root: Root  # [New in Capella]  # noqa: F821


class Validator(Container):  # noqa: F821
    pubkey: BLSPubkey  # noqa: F821
    withdrawal_credentials: Bytes32  # noqa: F821
    effective_balance: Gwei  # noqa: F821
    slashed: boolean  # noqa: F821
    activation_eligibility_epoch: Epoch  # noqa: F821
    activation_epoch: Epoch  # noqa: F821
    exit_epoch: Epoch  # noqa: F821
    withdrawable_epoch: Epoch  # noqa: F821
    fully_withdrawn_epoch: Epoch  # [New in Capella]  # noqa: F821


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
    execution_payload: ExecutionPayload
    bls_to_execution_changes: List[SignedBLSToExecutionChange, MAX_BLS_TO_EXECUTION_CHANGES]  # [New in Capella]  # noqa: F821


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
    latest_execution_payload_header: ExecutionPayloadHeader
    # Withdrawals [New in Capella]
    withdrawal_index: WithdrawalIndex
    withdrawals_queue: List[Withdrawal, WITHDRAWALS_QUEUE_LIMIT]  # noqa: F821


# ---------------------------------------------------------------------------
# Mutators & predicates (capella/beacon-chain.md:258-283)
# ---------------------------------------------------------------------------

def withdraw_balance(state: "BeaconState", index, amount) -> None:
    decrease_balance(state, index, amount)  # noqa: F821
    withdrawal = Withdrawal(
        index=state.withdrawal_index,
        address=bytes(state.validators[index].withdrawal_credentials)[12:],
        amount=amount,
    )
    state.withdrawal_index = WithdrawalIndex(state.withdrawal_index + 1)
    state.withdrawals_queue.append(withdrawal)


def is_fully_withdrawable_validator(validator: "Validator", epoch) -> bool:
    is_eth1_withdrawal_prefix = (
        bytes(validator.withdrawal_credentials)[:1] == bytes(ETH1_ADDRESS_WITHDRAWAL_PREFIX)  # noqa: F821
    )
    return is_eth1_withdrawal_prefix and validator.withdrawable_epoch <= epoch < validator.fully_withdrawn_epoch


# ---------------------------------------------------------------------------
# Epoch processing (capella/beacon-chain.md:290-318)
# ---------------------------------------------------------------------------

def epoch_process_steps():
    return [
        process_justification_and_finalization,  # noqa: F821
        process_inactivity_updates,  # noqa: F821
        process_rewards_and_penalties,  # noqa: F821
        process_registry_updates,  # noqa: F821
        process_slashings,  # noqa: F821
        process_eth1_data_reset,  # noqa: F821
        process_effective_balance_updates,  # noqa: F821
        process_slashings_reset,  # noqa: F821
        process_randao_mixes_reset,  # noqa: F821
        process_historical_roots_update,  # noqa: F821
        process_participation_flag_updates,  # noqa: F821
        process_sync_committee_updates,  # noqa: F821
        process_full_withdrawals,  # [New in Capella]
    ]


def process_full_withdrawals(state: "BeaconState") -> None:
    current_epoch = get_current_epoch(state)  # noqa: F821
    for index, validator in enumerate(state.validators):
        if is_fully_withdrawable_validator(validator, current_epoch):
            withdraw_balance(state, ValidatorIndex(index), state.balances[index])  # noqa: F821
            validator.fully_withdrawn_epoch = current_epoch


# ---------------------------------------------------------------------------
# Block processing (capella/beacon-chain.md:322-427)
# ---------------------------------------------------------------------------

def process_block(state: "BeaconState", block: BeaconBlock) -> None:
    process_block_header(state, block)  # noqa: F821
    if is_execution_enabled(state, block.body):  # noqa: F821
        process_withdrawals(state, block.body.execution_payload)  # [New in Capella]
        process_execution_payload(state, block.body.execution_payload, EXECUTION_ENGINE)  # noqa: F821
    process_randao(state, block.body)  # noqa: F821
    process_eth1_data(state, block.body)  # noqa: F821
    process_operations(state, block.body)  # noqa: F821
    process_sync_aggregate(state, block.body.sync_aggregate)  # noqa: F821


def block_process_steps():
    def _maybe_withdrawals(state, block):
        if is_execution_enabled(state, block.body):  # noqa: F821
            process_withdrawals(state, block.body.execution_payload)

    def _maybe_payload(state, block):
        if is_execution_enabled(state, block.body):  # noqa: F821
            process_execution_payload(state, block.body.execution_payload, EXECUTION_ENGINE)  # noqa: F821

    return [
        ("process_block_header", lambda state, block: process_block_header(state, block)),  # noqa: F821
        ("process_withdrawals", _maybe_withdrawals),
        ("process_execution_payload", _maybe_payload),
        ("process_randao", lambda state, block: process_randao(state, block.body)),  # noqa: F821
        ("process_eth1_data", lambda state, block: process_eth1_data(state, block.body)),  # noqa: F821
        ("process_operations", lambda state, block: process_operations(state, block.body)),  # noqa: F821
        ("process_sync_aggregate", lambda state, block: process_sync_aggregate(state, block.body.sync_aggregate)),  # noqa: F821
    ]


def process_withdrawals(state: "BeaconState", payload: ExecutionPayload) -> None:
    num_withdrawals = min(int(MAX_WITHDRAWALS_PER_PAYLOAD), len(state.withdrawals_queue))  # noqa: F821
    dequeued_withdrawals = [state.withdrawals_queue[i] for i in range(num_withdrawals)]

    assert len(dequeued_withdrawals) == len(payload.withdrawals)
    for dequeued_withdrawal, withdrawal in zip(dequeued_withdrawals, payload.withdrawals):
        assert dequeued_withdrawal == withdrawal

    state.withdrawals_queue = [
        state.withdrawals_queue[i] for i in range(num_withdrawals, len(state.withdrawals_queue))
    ]


def process_execution_payload(state: "BeaconState", payload: ExecutionPayload, execution_engine) -> None:
    if is_merge_transition_complete(state):  # noqa: F821
        assert payload.parent_hash == state.latest_execution_payload_header.block_hash
    assert payload.prev_randao == get_randao_mix(state, get_current_epoch(state))  # noqa: F821
    assert payload.timestamp == compute_timestamp_at_slot(state, state.slot)  # noqa: F821
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
        withdrawals_root=hash_tree_root(payload.withdrawals),  # [New in Capella]  # noqa: F821
    )


def process_operations(state: "BeaconState", body: BeaconBlockBody) -> None:
    assert len(body.deposits) == min(
        MAX_DEPOSITS, state.eth1_data.deposit_count - state.eth1_deposit_index  # noqa: F821
    )

    def for_ops(operations, fn) -> None:
        for operation in operations:
            fn(state, operation)

    for_ops(body.proposer_slashings, process_proposer_slashing)  # noqa: F821
    for_ops(body.attester_slashings, process_attester_slashing)  # noqa: F821
    for_ops(body.attestations, process_attestation)  # noqa: F821
    for_ops(body.deposits, process_deposit)  # noqa: F821
    for_ops(body.voluntary_exits, process_voluntary_exit)  # noqa: F821
    for_ops(body.bls_to_execution_changes, process_bls_to_execution_change)  # [New in Capella]


def process_bls_to_execution_change(state: "BeaconState",
                                    signed_address_change: SignedBLSToExecutionChange) -> None:
    """Rotate BLS withdrawal credentials to an eth1 address
    (capella/beacon-chain.md:408)."""
    address_change = signed_address_change.message

    assert address_change.validator_index < len(state.validators)

    validator = state.validators[address_change.validator_index]

    assert bytes(validator.withdrawal_credentials)[:1] == bytes(BLS_WITHDRAWAL_PREFIX)  # noqa: F821
    assert bytes(validator.withdrawal_credentials)[1:] == hash(address_change.from_bls_pubkey)[1:]  # noqa: F821

    domain = get_domain(state, DOMAIN_BLS_TO_EXECUTION_CHANGE)  # noqa: F821
    signing_root = compute_signing_root(address_change, domain)  # noqa: F821
    assert bls.Verify(address_change.from_bls_pubkey, signing_root, signed_address_change.signature)  # noqa: F821

    validator.withdrawal_credentials = (
        bytes(ETH1_ADDRESS_WITHDRAWAL_PREFIX)  # noqa: F821
        + b"\x00" * 11
        + bytes(address_change.to_execution_address)
    )


# ---------------------------------------------------------------------------
# Fork upgrade (capella/fork.md:46-110)
# ---------------------------------------------------------------------------

def upgrade_to_capella(pre) -> "BeaconState":
    epoch = compute_epoch_at_slot(pre.slot)  # noqa: F821
    post = BeaconState(
        genesis_time=pre.genesis_time,
        genesis_validators_root=pre.genesis_validators_root,
        slot=pre.slot,
        fork=Fork(  # noqa: F821
            previous_version=pre.fork.current_version,
            current_version=config.CAPELLA_FORK_VERSION,  # noqa: F821
            epoch=epoch,
        ),
        latest_block_header=pre.latest_block_header,
        block_roots=pre.block_roots,
        state_roots=pre.state_roots,
        historical_roots=pre.historical_roots,
        eth1_data=pre.eth1_data,
        eth1_data_votes=pre.eth1_data_votes,
        eth1_deposit_index=pre.eth1_deposit_index,
        validators=[],
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
        # Rebuilt below: the capella header adds withdrawals_root
        latest_execution_payload_header=ExecutionPayloadHeader(),
        withdrawal_index=WithdrawalIndex(0),
        withdrawals_queue=[],
    )
    pre_header = pre.latest_execution_payload_header
    post.latest_execution_payload_header = ExecutionPayloadHeader(
        parent_hash=pre_header.parent_hash,
        fee_recipient=pre_header.fee_recipient,
        state_root=pre_header.state_root,
        receipts_root=pre_header.receipts_root,
        logs_bloom=pre_header.logs_bloom,
        prev_randao=pre_header.prev_randao,
        block_number=pre_header.block_number,
        gas_limit=pre_header.gas_limit,
        gas_used=pre_header.gas_used,
        timestamp=pre_header.timestamp,
        extra_data=pre_header.extra_data,
        base_fee_per_gas=pre_header.base_fee_per_gas,
        block_hash=pre_header.block_hash,
        transactions_root=pre_header.transactions_root,
        withdrawals_root=Root(),  # noqa: F821
    )

    for pre_validator in pre.validators:
        post_validator = Validator(
            pubkey=pre_validator.pubkey,
            withdrawal_credentials=pre_validator.withdrawal_credentials,
            effective_balance=pre_validator.effective_balance,
            slashed=pre_validator.slashed,
            activation_eligibility_epoch=pre_validator.activation_eligibility_epoch,
            activation_epoch=pre_validator.activation_epoch,
            exit_epoch=pre_validator.exit_epoch,
            withdrawable_epoch=pre_validator.withdrawable_epoch,
            fully_withdrawn_epoch=FAR_FUTURE_EPOCH,  # noqa: F821
        )
        post.validators.append(post_validator)

    return post


# ---------------------------------------------------------------------------
# Validator guide (capella/validator.md)
# ---------------------------------------------------------------------------

def get_expected_withdrawals(state: "BeaconState"):
    num_withdrawals = min(int(MAX_WITHDRAWALS_PER_PAYLOAD), len(state.withdrawals_queue))  # noqa: F821
    return [state.withdrawals_queue[i] for i in range(num_withdrawals)]


@_dataclass
class PayloadAttributes:  # noqa: F811 (capella delta: + withdrawals)
    timestamp: "uint64"  # noqa: F821
    prev_randao: "Bytes32"  # noqa: F821
    suggested_fee_recipient: "ExecutionAddress"  # noqa: F821
    withdrawals: list  # [New in Capella] Sequence[Withdrawal]


def prepare_execution_payload(state: "BeaconState", pow_chain, safe_block_hash,
                              finalized_block_hash, suggested_fee_recipient,
                              execution_engine) -> "_Optional[PayloadId]":  # noqa: F821
    """Bellatrix flow, except the slot's expected withdrawals ride the
    PayloadAttributes into the engine (capella/validator.md:72-108)."""
    if not is_merge_transition_complete(state):  # noqa: F821
        is_terminal_block_hash_set = config.TERMINAL_BLOCK_HASH != Hash32()  # noqa: F821
        is_activation_epoch_reached = (
            get_current_epoch(state) >= config.TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH  # noqa: F821
        )
        if is_terminal_block_hash_set and not is_activation_epoch_reached:
            return None
        terminal_pow_block = get_terminal_pow_block(pow_chain)  # noqa: F821
        if terminal_pow_block is None:
            return None  # pre-merge, no payload yet
        parent_hash = terminal_pow_block.block_hash
    else:
        parent_hash = state.latest_execution_payload_header.block_hash

    payload_attributes = PayloadAttributes(
        timestamp=compute_timestamp_at_slot(state, state.slot),  # noqa: F821
        prev_randao=get_randao_mix(state, get_current_epoch(state)),  # noqa: F821
        suggested_fee_recipient=suggested_fee_recipient,
        withdrawals=get_expected_withdrawals(state),  # [New in Capella]
    )
    return execution_engine.notify_forkchoice_updated(
        parent_hash, safe_block_hash, finalized_block_hash, payload_attributes
    )
