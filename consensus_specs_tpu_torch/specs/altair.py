"""Altair spec source (delta over phase0).

Covers specs/altair/{beacon-chain,bls,fork,sync-protocol,validator}.md at
v1.1.10: sync committees, participation-flag incentive accounting,
inactivity scores, the light-client sync protocol, and sync-committee
validator duties. Executed by specs.build on top of the phase0 namespace —
names not redefined here late-bind to the final module namespace.

Implementation notes: sync-committee sampling reuses the cached batched
shuffle permutation; the 512-key sync-aggregate verify routes through the
bls facade's batch path (the showcase workload of BASELINE config #4);
process_sync_aggregate finds the committee's validator indices through one
pubkey -> first-index map, where the spec scans the registry once per
committee seat (list.index: 512 scans of the registry a block).
"""
from dataclasses import dataclass as _dataclass
from typing import Optional as _Optional

import math as _math


# ---------------------------------------------------------------------------
# Custom types & constants (altair/beacon-chain.md:80-160)
# ---------------------------------------------------------------------------

class ParticipationFlags(uint8):  # noqa: F821
    pass


TIMELY_SOURCE_FLAG_INDEX = 0
TIMELY_TARGET_FLAG_INDEX = 1
TIMELY_HEAD_FLAG_INDEX = 2

TIMELY_SOURCE_WEIGHT = uint64(14)  # noqa: F821
TIMELY_TARGET_WEIGHT = uint64(26)  # noqa: F821
TIMELY_HEAD_WEIGHT = uint64(14)  # noqa: F821
SYNC_REWARD_WEIGHT = uint64(2)  # noqa: F821
PROPOSER_WEIGHT = uint64(8)  # noqa: F821
WEIGHT_DENOMINATOR = uint64(64)  # noqa: F821

PARTICIPATION_FLAG_WEIGHTS = [TIMELY_SOURCE_WEIGHT, TIMELY_TARGET_WEIGHT, TIMELY_HEAD_WEIGHT]

DOMAIN_SYNC_COMMITTEE = DomainType(b"\x07\x00\x00\x00")  # noqa: F821
DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = DomainType(b"\x08\x00\x00\x00")  # noqa: F821
DOMAIN_CONTRIBUTION_AND_PROOF = DomainType(b"\x09\x00\x00\x00")  # noqa: F821

G2_POINT_AT_INFINITY = BLSSignature(b"\xc0" + b"\x00" * 95)  # noqa: F821

# Validator guide (altair/validator.md:70-80)
TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE = 2**4
SYNC_COMMITTEE_SUBNET_COUNT = 4

# Light client (altair/sync-protocol.md:44-57); verified against
# get_generalized_index below after BeaconState is defined.
FINALIZED_ROOT_INDEX = 105
NEXT_SYNC_COMMITTEE_INDEX = 55

GeneralizedIndex = int


def floorlog2(x) -> int:
    return int(x).bit_length() - 1


# ---------------------------------------------------------------------------
# Containers (altair/beacon-chain.md:160-230)
# ---------------------------------------------------------------------------

class SyncAggregate(Container):  # noqa: F821
    sync_committee_bits: Bitvector[SYNC_COMMITTEE_SIZE]  # noqa: F821
    sync_committee_signature: BLSSignature  # noqa: F821


class SyncCommittee(Container):  # noqa: F821
    pubkeys: Vector[BLSPubkey, SYNC_COMMITTEE_SIZE]  # noqa: F821
    aggregate_pubkey: BLSPubkey  # noqa: F821


class BeaconBlockBody(Container):  # noqa: F821
    randao_reveal: BLSSignature  # noqa: F821
    eth1_data: Eth1Data  # noqa: F821
    graffiti: Bytes32  # noqa: F821
    proposer_slashings: List[ProposerSlashing, MAX_PROPOSER_SLASHINGS]  # noqa: F821
    attester_slashings: List[AttesterSlashing, MAX_ATTESTER_SLASHINGS]  # noqa: F821
    attestations: List[Attestation, MAX_ATTESTATIONS]  # noqa: F821
    deposits: List[Deposit, MAX_DEPOSITS]  # noqa: F821
    voluntary_exits: List[SignedVoluntaryExit, MAX_VOLUNTARY_EXITS]  # noqa: F821
    sync_aggregate: SyncAggregate  # [New in Altair]


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
    # Versioning
    genesis_time: uint64  # noqa: F821
    genesis_validators_root: Root  # noqa: F821
    slot: Slot  # noqa: F821
    fork: Fork  # noqa: F821
    # History
    latest_block_header: BeaconBlockHeader  # noqa: F821
    block_roots: Vector[Root, SLOTS_PER_HISTORICAL_ROOT]  # noqa: F821
    state_roots: Vector[Root, SLOTS_PER_HISTORICAL_ROOT]  # noqa: F821
    historical_roots: List[Root, HISTORICAL_ROOTS_LIMIT]  # noqa: F821
    # Eth1
    eth1_data: Eth1Data  # noqa: F821
    eth1_data_votes: List[Eth1Data, EPOCHS_PER_ETH1_VOTING_PERIOD * SLOTS_PER_EPOCH]  # noqa: F821
    eth1_deposit_index: uint64  # noqa: F821
    # Registry
    validators: List[Validator, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    balances: List[Gwei, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    # Randomness
    randao_mixes: Vector[Bytes32, EPOCHS_PER_HISTORICAL_VECTOR]  # noqa: F821
    # Slashings
    slashings: Vector[Gwei, EPOCHS_PER_SLASHINGS_VECTOR]  # noqa: F821
    # Participation [Modified in Altair]
    previous_epoch_participation: List[ParticipationFlags, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    current_epoch_participation: List[ParticipationFlags, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    # Finality
    justification_bits: Bitvector[JUSTIFICATION_BITS_LENGTH]  # noqa: F821
    previous_justified_checkpoint: Checkpoint  # noqa: F821
    current_justified_checkpoint: Checkpoint  # noqa: F821
    finalized_checkpoint: Checkpoint  # noqa: F821
    # Inactivity [New in Altair]
    inactivity_scores: List[uint64, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    # Sync [New in Altair]
    current_sync_committee: SyncCommittee
    next_sync_committee: SyncCommittee


# Compiler-style verification of the hardcoded light-client gindices
# (ref setup.py:653-654,673-675)
assert FINALIZED_ROOT_INDEX == get_generalized_index(BeaconState, "finalized_checkpoint", "root")  # noqa: F821
assert NEXT_SYNC_COMMITTEE_INDEX == get_generalized_index(BeaconState, "next_sync_committee")  # noqa: F821


# ---------------------------------------------------------------------------
# BLS extensions (altair/bls.md:39-68)
# ---------------------------------------------------------------------------

def eth_aggregate_pubkeys(pubkeys):
    """EC point-sum of pubkeys; the compiler swaps in the optimized
    bls.AggregatePKs (ref setup.py:489-492) — here the facade IS the
    optimized path."""
    assert len(pubkeys) > 0
    return BLSPubkey(bls.AggregatePKs(list(pubkeys)))  # noqa: F821


def eth_fast_aggregate_verify(pubkeys, message, signature) -> bool:
    """FastAggregateVerify tolerating the G2 infinity signature over an
    empty key set (altair/bls.md:61)."""
    if len(pubkeys) == 0 and signature == G2_POINT_AT_INFINITY:
        return True
    return bls.FastAggregateVerify(list(pubkeys), message, signature)  # noqa: F821


# ---------------------------------------------------------------------------
# Participation flags (altair/beacon-chain.md:230-250)
# ---------------------------------------------------------------------------

def add_flag(flags: ParticipationFlags, flag_index: int) -> ParticipationFlags:
    flag = ParticipationFlags(2**flag_index)
    return ParticipationFlags(flags | flag)


def has_flag(flags: ParticipationFlags, flag_index: int) -> bool:
    flag = ParticipationFlags(2**flag_index)
    return flags & flag == flag


# ---------------------------------------------------------------------------
# Sync committee accessors (altair/beacon-chain.md:256-300)
# ---------------------------------------------------------------------------

def get_next_sync_committee_indices(state: "BeaconState"):
    """Balance-weighted sampling (with duplicates) of the next period's
    committee; uses the cached batched shuffle permutation."""
    epoch = Epoch(get_current_epoch(state) + 1)  # noqa: F821

    MAX_RANDOM_BYTE = 2**8 - 1
    active_validator_indices = get_active_validator_indices(state, epoch)  # noqa: F821
    active_validator_count = uint64(len(active_validator_indices))  # noqa: F821
    seed = get_seed(state, epoch, DOMAIN_SYNC_COMMITTEE)  # noqa: F821
    perm = _shuffle_permutation(int(active_validator_count), seed)  # noqa: F821
    i = 0
    sync_committee_indices = []
    while len(sync_committee_indices) < SYNC_COMMITTEE_SIZE:  # noqa: F821
        shuffled_index = perm[i % active_validator_count]
        candidate_index = active_validator_indices[shuffled_index]
        random_byte = hash(seed + uint_to_bytes(uint64(i // 32)))[i % 32]  # noqa: F821
        effective_balance = state.validators[candidate_index].effective_balance
        if effective_balance * MAX_RANDOM_BYTE >= MAX_EFFECTIVE_BALANCE * random_byte:  # noqa: F821
            sync_committee_indices.append(candidate_index)
        i += 1
    return sync_committee_indices


def get_next_sync_committee(state: "BeaconState") -> SyncCommittee:
    indices = get_next_sync_committee_indices(state)
    pubkeys = [state.validators[index].pubkey for index in indices]
    aggregate_pubkey = eth_aggregate_pubkeys(pubkeys)
    return SyncCommittee(pubkeys=pubkeys, aggregate_pubkey=aggregate_pubkey)


# ---------------------------------------------------------------------------
# Incentive accounting (altair/beacon-chain.md:300-440)
# ---------------------------------------------------------------------------

def get_base_reward_per_increment(state: "BeaconState") -> "Gwei":  # noqa: F821
    return Gwei(  # noqa: F821
        EFFECTIVE_BALANCE_INCREMENT * BASE_REWARD_FACTOR  # noqa: F821
        // integer_squareroot(get_total_active_balance(state))  # noqa: F821
    )


def get_base_reward(state: "BeaconState", index) -> "Gwei":  # noqa: F821
    """Increment-based accounting (replaces BASE_REWARDS_PER_EPOCH)."""
    increments = state.validators[index].effective_balance // EFFECTIVE_BALANCE_INCREMENT  # noqa: F821
    return Gwei(increments * get_base_reward_per_increment(state))  # noqa: F821


def get_unslashed_participating_indices(state: "BeaconState", flag_index: int, epoch):
    assert epoch in (get_previous_epoch(state), get_current_epoch(state))  # noqa: F821
    if epoch == get_current_epoch(state):  # noqa: F821
        epoch_participation = state.current_epoch_participation
    else:
        epoch_participation = state.previous_epoch_participation
    active_validator_indices = get_active_validator_indices(state, epoch)  # noqa: F821
    participating_indices = [
        i for i in active_validator_indices if has_flag(epoch_participation[i], flag_index)
    ]
    return set(filter(lambda index: not state.validators[index].slashed, participating_indices))


def get_attestation_participation_flag_indices(state: "BeaconState", data, inclusion_delay):
    """Flag indices an attestation satisfies (timely source/target/head)."""
    if data.target.epoch == get_current_epoch(state):  # noqa: F821
        justified_checkpoint = state.current_justified_checkpoint
    else:
        justified_checkpoint = state.previous_justified_checkpoint

    is_matching_source = data.source == justified_checkpoint
    is_matching_target = is_matching_source and data.target.root == get_block_root(state, data.target.epoch)  # noqa: F821
    is_matching_head = is_matching_target and data.beacon_block_root == get_block_root_at_slot(state, data.slot)  # noqa: F821
    assert is_matching_source

    participation_flag_indices = []
    if is_matching_source and inclusion_delay <= integer_squareroot(SLOTS_PER_EPOCH):  # noqa: F821
        participation_flag_indices.append(TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= SLOTS_PER_EPOCH:  # noqa: F821
        participation_flag_indices.append(TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == MIN_ATTESTATION_INCLUSION_DELAY:  # noqa: F821
        participation_flag_indices.append(TIMELY_HEAD_FLAG_INDEX)

    return participation_flag_indices


def get_flag_index_deltas(state: "BeaconState", flag_index: int):
    """Per-flag rewards/penalties; totals hoisted out of the loop
    (bit-identical to altair/beacon-chain.md:367)."""
    rewards = [Gwei(0)] * len(state.validators)  # noqa: F821
    penalties = [Gwei(0)] * len(state.validators)  # noqa: F821
    previous_epoch = get_previous_epoch(state)  # noqa: F821
    unslashed_participating_indices = get_unslashed_participating_indices(state, flag_index, previous_epoch)
    weight = PARTICIPATION_FLAG_WEIGHTS[flag_index]
    unslashed_participating_balance = get_total_balance(state, unslashed_participating_indices)  # noqa: F821
    unslashed_participating_increments = unslashed_participating_balance // EFFECTIVE_BALANCE_INCREMENT  # noqa: F821
    active_increments = get_total_active_balance(state) // EFFECTIVE_BALANCE_INCREMENT  # noqa: F821
    base_reward_per_increment = get_base_reward_per_increment(state)
    leak = is_in_inactivity_leak(state)  # noqa: F821
    for index in get_eligible_validator_indices(state):  # noqa: F821
        increments = state.validators[index].effective_balance // EFFECTIVE_BALANCE_INCREMENT  # noqa: F821
        base_reward = Gwei(increments * base_reward_per_increment)  # noqa: F821
        if index in unslashed_participating_indices:
            if not leak:
                reward_numerator = base_reward * weight * unslashed_participating_increments
                rewards[index] += Gwei(reward_numerator // (active_increments * WEIGHT_DENOMINATOR))  # noqa: F821
        elif flag_index != TIMELY_HEAD_FLAG_INDEX:
            penalties[index] += Gwei(base_reward * weight // WEIGHT_DENOMINATOR)  # noqa: F821
    return rewards, penalties


def get_inactivity_penalty_deltas(state: "BeaconState"):
    """Inactivity-score-scaled penalties (altair/beacon-chain.md:390)."""
    rewards = [Gwei(0) for _ in range(len(state.validators))]  # noqa: F821
    penalties = [Gwei(0) for _ in range(len(state.validators))]  # noqa: F821
    previous_epoch = get_previous_epoch(state)  # noqa: F821
    matching_target_indices = get_unslashed_participating_indices(state, TIMELY_TARGET_FLAG_INDEX, previous_epoch)
    penalty_denominator = config.INACTIVITY_SCORE_BIAS * INACTIVITY_PENALTY_QUOTIENT_ALTAIR  # noqa: F821
    for index in get_eligible_validator_indices(state):  # noqa: F821
        if index not in matching_target_indices:
            penalty_numerator = state.validators[index].effective_balance * state.inactivity_scores[index]
            penalties[index] += Gwei(penalty_numerator // penalty_denominator)  # noqa: F821
    return rewards, penalties


def slash_validator(state: "BeaconState", slashed_index, whistleblower_index=None) -> None:
    """Altair: MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR + PROPOSER_WEIGHT-based
    proposer reward (altair/beacon-chain.md:440)."""
    epoch = get_current_epoch(state)  # noqa: F821
    initiate_validator_exit(state, slashed_index)  # noqa: F821
    validator = state.validators[slashed_index]
    validator.slashed = True
    validator.withdrawable_epoch = max(validator.withdrawable_epoch, Epoch(epoch + EPOCHS_PER_SLASHINGS_VECTOR))  # noqa: F821
    state.slashings[epoch % EPOCHS_PER_SLASHINGS_VECTOR] += validator.effective_balance  # noqa: F821
    decrease_balance(state, slashed_index, validator.effective_balance // MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR)  # noqa: F821

    proposer_index = get_beacon_proposer_index(state)  # noqa: F821
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = Gwei(validator.effective_balance // WHISTLEBLOWER_REWARD_QUOTIENT)  # noqa: F821
    proposer_reward = Gwei(whistleblower_reward * PROPOSER_WEIGHT // WEIGHT_DENOMINATOR)  # noqa: F821
    increase_balance(state, proposer_index, proposer_reward)  # noqa: F821
    increase_balance(state, whistleblower_index, Gwei(whistleblower_reward - proposer_reward))  # noqa: F821


# ---------------------------------------------------------------------------
# Block processing (altair/beacon-chain.md:444-565)
# ---------------------------------------------------------------------------

def process_block(state: "BeaconState", block: BeaconBlock) -> None:
    process_block_header(state, block)  # noqa: F821
    process_randao(state, block.body)  # noqa: F821
    process_eth1_data(state, block.body)  # noqa: F821
    process_operations(state, block.body)  # noqa: F821  [Modified in Altair]
    process_sync_aggregate(state, block.body.sync_aggregate)  # [New in Altair]


def block_process_steps():
    return [
        ("process_block_header", lambda state, block: process_block_header(state, block)),  # noqa: F821
        ("process_randao", lambda state, block: process_randao(state, block.body)),  # noqa: F821
        ("process_eth1_data", lambda state, block: process_eth1_data(state, block.body)),  # noqa: F821
        ("process_operations", lambda state, block: process_operations(state, block.body)),  # noqa: F821
        ("process_sync_aggregate", lambda state, block: process_sync_aggregate(state, block.body.sync_aggregate)),
    ]


def process_attestation(state: "BeaconState", attestation) -> None:
    """Altair: participation-flag accounting + immediate proposer reward."""
    data = attestation.data
    assert data.target.epoch in (get_previous_epoch(state), get_current_epoch(state))  # noqa: F821
    assert data.target.epoch == compute_epoch_at_slot(data.slot)  # noqa: F821
    assert data.slot + MIN_ATTESTATION_INCLUSION_DELAY <= state.slot <= data.slot + SLOTS_PER_EPOCH  # noqa: F821
    assert data.index < get_committee_count_per_slot(state, data.target.epoch)  # noqa: F821

    committee = get_beacon_committee(state, data.slot, data.index)  # noqa: F821
    assert len(attestation.aggregation_bits) == len(committee)

    participation_flag_indices = get_attestation_participation_flag_indices(
        state, data, state.slot - data.slot
    )

    assert is_valid_indexed_attestation(state, get_indexed_attestation(state, attestation))  # noqa: F821

    if data.target.epoch == get_current_epoch(state):  # noqa: F821
        epoch_participation = state.current_epoch_participation
    else:
        epoch_participation = state.previous_epoch_participation

    proposer_reward_numerator = 0
    for index in get_attesting_indices(state, data, attestation.aggregation_bits):  # noqa: F821
        for flag_index, weight in enumerate(PARTICIPATION_FLAG_WEIGHTS):
            if flag_index in participation_flag_indices and not has_flag(epoch_participation[index], flag_index):
                epoch_participation[index] = add_flag(epoch_participation[index], flag_index)
                proposer_reward_numerator += get_base_reward(state, index) * weight

    proposer_reward_denominator = (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT) * WEIGHT_DENOMINATOR // PROPOSER_WEIGHT  # noqa: F821
    proposer_reward = Gwei(proposer_reward_numerator // proposer_reward_denominator)  # noqa: F821
    increase_balance(state, get_beacon_proposer_index(state), proposer_reward)  # noqa: F821


def process_deposit(state: "BeaconState", deposit) -> None:
    """Altair: new validators also get participation/inactivity entries."""
    assert is_valid_merkle_branch(  # noqa: F821
        leaf=hash_tree_root(deposit.data),  # noqa: F821
        branch=deposit.proof,
        depth=DEPOSIT_CONTRACT_TREE_DEPTH + 1,  # noqa: F821
        index=state.eth1_deposit_index,
        root=state.eth1_data.deposit_root,
    )
    state.eth1_deposit_index += 1

    pubkey = deposit.data.pubkey
    amount = deposit.data.amount
    validator_pubkeys = [validator.pubkey for validator in state.validators]
    if pubkey not in validator_pubkeys:
        deposit_message = DepositMessage(  # noqa: F821
            pubkey=deposit.data.pubkey,
            withdrawal_credentials=deposit.data.withdrawal_credentials,
            amount=deposit.data.amount,
        )
        domain = compute_domain(DOMAIN_DEPOSIT)  # noqa: F821
        signing_root = compute_signing_root(deposit_message, domain)  # noqa: F821
        if bls.Verify(pubkey, signing_root, deposit.data.signature):  # noqa: F821
            state.validators.append(get_validator_from_deposit(deposit))  # noqa: F821
            state.balances.append(amount)
            state.previous_epoch_participation.append(ParticipationFlags(0b0000_0000))
            state.current_epoch_participation.append(ParticipationFlags(0b0000_0000))
            state.inactivity_scores.append(uint64(0))  # noqa: F821
    else:
        index = ValidatorIndex(validator_pubkeys.index(pubkey))  # noqa: F821
        increase_balance(state, index, amount)  # noqa: F821


def process_sync_aggregate(state: "BeaconState", sync_aggregate: SyncAggregate) -> None:
    """Verify the (<=SYNC_COMMITTEE_SIZE)-key aggregate over the previous
    slot's block root, then apply participant/proposer rewards — the
    framework's batch-verify showcase (BASELINE config #4)."""
    committee_pubkeys = state.current_sync_committee.pubkeys
    participant_pubkeys = [
        pubkey for pubkey, bit in zip(committee_pubkeys, sync_aggregate.sync_committee_bits) if bit
    ]
    previous_slot = max(state.slot, Slot(1)) - Slot(1)  # noqa: F821
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, compute_epoch_at_slot(previous_slot))  # noqa: F821
    signing_root = compute_signing_root(get_block_root_at_slot(state, previous_slot), domain)  # noqa: F821
    assert eth_fast_aggregate_verify(
        participant_pubkeys, signing_root, sync_aggregate.sync_committee_signature
    )

    # Rewards
    total_active_increments = get_total_active_balance(state) // EFFECTIVE_BALANCE_INCREMENT  # noqa: F821
    total_base_rewards = Gwei(get_base_reward_per_increment(state) * total_active_increments)  # noqa: F821
    max_participant_rewards = Gwei(  # noqa: F821
        total_base_rewards * SYNC_REWARD_WEIGHT // WEIGHT_DENOMINATOR // SLOTS_PER_EPOCH  # noqa: F821
    )
    participant_reward = Gwei(max_participant_rewards // SYNC_COMMITTEE_SIZE)  # noqa: F821
    proposer_reward = Gwei(participant_reward * PROPOSER_WEIGHT // (WEIGHT_DENOMINATOR - PROPOSER_WEIGHT))  # noqa: F821

    # all_pubkeys.index(pubkey) for each seat, as one map: the first index
    # of every pubkey in the registry, which is what list.index returns
    first_index = {}
    for index, validator in enumerate(state.validators):
        first_index.setdefault(validator.pubkey, index)
    committee_indices = []
    for pubkey in state.current_sync_committee.pubkeys:
        if pubkey not in first_index:
            raise ValueError(f"{pubkey!r} is not in list")  # list.index's error
        committee_indices.append(ValidatorIndex(first_index[pubkey]))  # noqa: F821
    for participant_index, participation_bit in zip(committee_indices, sync_aggregate.sync_committee_bits):
        if participation_bit:
            increase_balance(state, participant_index, participant_reward)  # noqa: F821
            increase_balance(state, get_beacon_proposer_index(state), proposer_reward)  # noqa: F821
        else:
            decrease_balance(state, participant_index, participant_reward)  # noqa: F821


# ---------------------------------------------------------------------------
# Epoch processing (altair/beacon-chain.md:570-680)
# ---------------------------------------------------------------------------

def epoch_process_steps():
    return [
        process_justification_and_finalization,  # noqa: F821  [Modified in Altair]
        process_inactivity_updates,  # [New in Altair]
        process_rewards_and_penalties,  # noqa: F821  [Modified in Altair]
        process_registry_updates,  # noqa: F821
        process_slashings,  # noqa: F821  [Modified in Altair]
        process_eth1_data_reset,  # noqa: F821
        process_effective_balance_updates,  # noqa: F821
        process_slashings_reset,  # noqa: F821
        process_randao_mixes_reset,  # noqa: F821
        process_historical_roots_update,  # noqa: F821
        process_participation_flag_updates,  # [New in Altair]
        process_sync_committee_updates,  # [New in Altair]
    ]


def process_justification_and_finalization(state: "BeaconState") -> None:
    # Skip FFG updates in the first two epochs (stub-root corner cases)
    if get_current_epoch(state) <= GENESIS_EPOCH + 1:  # noqa: F821
        return
    previous_indices = get_unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, get_previous_epoch(state)  # noqa: F821
    )
    current_indices = get_unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, get_current_epoch(state)  # noqa: F821
    )
    total_active_balance = get_total_active_balance(state)  # noqa: F821
    previous_target_balance = get_total_balance(state, previous_indices)  # noqa: F821
    current_target_balance = get_total_balance(state, current_indices)  # noqa: F821
    weigh_justification_and_finalization(  # noqa: F821
        state, total_active_balance, previous_target_balance, current_target_balance
    )


def process_inactivity_updates(state: "BeaconState") -> None:
    """Leak-score bookkeeping (altair/beacon-chain.md:608)."""
    if get_current_epoch(state) == GENESIS_EPOCH:  # noqa: F821
        return

    participating = get_unslashed_participating_indices(
        state, TIMELY_TARGET_FLAG_INDEX, get_previous_epoch(state)  # noqa: F821
    )
    leak = is_in_inactivity_leak(state)  # noqa: F821
    for index in get_eligible_validator_indices(state):  # noqa: F821
        if index in participating:
            state.inactivity_scores[index] -= min(1, state.inactivity_scores[index])
        else:
            state.inactivity_scores[index] += config.INACTIVITY_SCORE_BIAS  # noqa: F821
        if not leak:
            state.inactivity_scores[index] -= min(
                int(config.INACTIVITY_SCORE_RECOVERY_RATE), state.inactivity_scores[index]  # noqa: F821
            )


def process_rewards_and_penalties(state: "BeaconState") -> None:
    if get_current_epoch(state) == GENESIS_EPOCH:  # noqa: F821
        return

    flag_deltas = [
        get_flag_index_deltas(state, flag_index)
        for flag_index in range(len(PARTICIPATION_FLAG_WEIGHTS))
    ]
    deltas = flag_deltas + [get_inactivity_penalty_deltas(state)]
    for (rewards, penalties) in deltas:
        for index in range(len(state.validators)):
            increase_balance(state, ValidatorIndex(index), rewards[index])  # noqa: F821
            decrease_balance(state, ValidatorIndex(index), penalties[index])  # noqa: F821


def process_slashings(state: "BeaconState") -> None:
    epoch = get_current_epoch(state)  # noqa: F821
    total_balance = get_total_active_balance(state)  # noqa: F821
    adjusted_total_slashing_balance = min(
        sum(int(s) for s in state.slashings) * PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR,  # noqa: F821
        total_balance,
    )
    increment = EFFECTIVE_BALANCE_INCREMENT  # noqa: F821
    for index, validator in enumerate(state.validators):
        if validator.slashed and epoch + EPOCHS_PER_SLASHINGS_VECTOR // 2 == validator.withdrawable_epoch:  # noqa: F821
            penalty_numerator = validator.effective_balance // increment * adjusted_total_slashing_balance
            penalty = penalty_numerator // total_balance * increment
            decrease_balance(state, ValidatorIndex(index), Gwei(penalty))  # noqa: F821


def process_participation_flag_updates(state: "BeaconState") -> None:
    state.previous_epoch_participation = state.current_epoch_participation
    state.current_epoch_participation = [
        ParticipationFlags(0b0000_0000) for _ in range(len(state.validators))
    ]


def process_sync_committee_updates(state: "BeaconState") -> None:
    next_epoch = get_current_epoch(state) + Epoch(1)  # noqa: F821
    if next_epoch % EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:  # noqa: F821
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(state)


# ---------------------------------------------------------------------------
# Altair genesis (testnets/vectors only; altair/beacon-chain.md:680-728)
# ---------------------------------------------------------------------------

def initialize_beacon_state_from_eth1(eth1_block_hash, eth1_timestamp, deposits) -> "BeaconState":
    fork = Fork(  # noqa: F821
        previous_version=config.ALTAIR_FORK_VERSION,  # noqa: F821
        current_version=config.ALTAIR_FORK_VERSION,  # noqa: F821
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
        process_deposit(state, deposit)

    for index, validator in enumerate(state.validators):
        balance = state.balances[index]
        validator.effective_balance = min(
            balance - balance % EFFECTIVE_BALANCE_INCREMENT, MAX_EFFECTIVE_BALANCE  # noqa: F821
        )
        if validator.effective_balance == MAX_EFFECTIVE_BALANCE:  # noqa: F821
            validator.activation_eligibility_epoch = GENESIS_EPOCH  # noqa: F821
            validator.activation_epoch = GENESIS_EPOCH  # noqa: F821

    state.genesis_validators_root = hash_tree_root(state.validators)  # noqa: F821

    # Duplicate committee for current and next at genesis
    state.current_sync_committee = get_next_sync_committee(state)
    state.next_sync_committee = get_next_sync_committee(state)

    return state


# ---------------------------------------------------------------------------
# Fork upgrade (altair/fork.md:46-107)
# ---------------------------------------------------------------------------

def translate_participation(state: "BeaconState", pending_attestations) -> None:
    """Convert phase0 PendingAttestations into participation flags."""
    for attestation in pending_attestations:
        data = attestation.data
        inclusion_delay = attestation.inclusion_delay
        participation_flag_indices = get_attestation_participation_flag_indices(state, data, inclusion_delay)

        epoch_participation = state.previous_epoch_participation
        for index in get_attesting_indices(state, data, attestation.aggregation_bits):  # noqa: F821
            for flag_index in participation_flag_indices:
                epoch_participation[index] = add_flag(epoch_participation[index], flag_index)


def upgrade_to_altair(pre) -> "BeaconState":
    epoch = compute_epoch_at_slot(pre.slot)  # noqa: F821
    post = BeaconState(
        genesis_time=pre.genesis_time,
        genesis_validators_root=pre.genesis_validators_root,
        slot=pre.slot,
        fork=Fork(  # noqa: F821
            previous_version=pre.fork.current_version,
            current_version=config.ALTAIR_FORK_VERSION,  # noqa: F821
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
        previous_epoch_participation=[ParticipationFlags(0b0000_0000) for _ in range(len(pre.validators))],
        current_epoch_participation=[ParticipationFlags(0b0000_0000) for _ in range(len(pre.validators))],
        justification_bits=pre.justification_bits,
        previous_justified_checkpoint=pre.previous_justified_checkpoint,
        current_justified_checkpoint=pre.current_justified_checkpoint,
        finalized_checkpoint=pre.finalized_checkpoint,
        inactivity_scores=[uint64(0) for _ in range(len(pre.validators))],  # noqa: F821
    )
    # Fill in previous epoch participation from pending attestations
    translate_participation(post, pre.previous_epoch_attestations)

    # Duplicate committee for current and next at the fork boundary
    post.current_sync_committee = get_next_sync_committee(post)
    post.next_sync_committee = get_next_sync_committee(post)
    return post


# ---------------------------------------------------------------------------
# Light client sync protocol (altair/sync-protocol.md)
# ---------------------------------------------------------------------------

class LightClientUpdate(Container):  # noqa: F821
    # Header attested to by the sync committee
    attested_header: BeaconBlockHeader  # noqa: F821
    # Next sync committee for the active header's period
    next_sync_committee: SyncCommittee
    next_sync_committee_branch: Vector[Bytes32, floorlog2(NEXT_SYNC_COMMITTEE_INDEX)]  # noqa: F821
    # Finalized header proven from the attested header's state
    finalized_header: BeaconBlockHeader  # noqa: F821
    finality_branch: Vector[Bytes32, floorlog2(FINALIZED_ROOT_INDEX)]  # noqa: F821
    sync_aggregate: SyncAggregate
    fork_version: Version  # noqa: F821


@_dataclass
class LightClientStore:
    finalized_header: "BeaconBlockHeader"  # noqa: F821
    current_sync_committee: SyncCommittee
    next_sync_committee: SyncCommittee
    best_valid_update: _Optional[LightClientUpdate]
    optimistic_header: "BeaconBlockHeader"  # noqa: F821
    previous_max_active_participants: int
    current_max_active_participants: int


def is_finality_update(update: LightClientUpdate) -> bool:
    return update.finalized_header != BeaconBlockHeader()  # noqa: F821


def get_subtree_index(generalized_index: GeneralizedIndex) -> int:
    return int(generalized_index % 2 ** (floorlog2(generalized_index)))


def get_active_header(update: LightClientUpdate):
    # Finalized header if present, else the attested header
    if is_finality_update(update):
        return update.finalized_header
    return update.attested_header


def get_safety_threshold(store: LightClientStore) -> int:
    return max(store.previous_max_active_participants, store.current_max_active_participants) // 2


def process_slot_for_light_client_store(store: LightClientStore, current_slot) -> None:
    if current_slot % UPDATE_TIMEOUT == 0:  # noqa: F821
        store.previous_max_active_participants = store.current_max_active_participants
        store.current_max_active_participants = 0
    if (
        current_slot > store.finalized_header.slot + UPDATE_TIMEOUT  # noqa: F821
        and store.best_valid_update is not None
    ):
        # Forced update after timeout
        apply_light_client_update(store, store.best_valid_update)
        store.best_valid_update = None


def validate_light_client_update(store: LightClientStore, update: LightClientUpdate,
                                 current_slot, genesis_validators_root) -> None:
    active_header = get_active_header(update)
    assert current_slot >= active_header.slot > store.finalized_header.slot

    # No skipped sync committee periods
    finalized_period = compute_sync_committee_period(compute_epoch_at_slot(store.finalized_header.slot))  # noqa: F821
    update_period = compute_sync_committee_period(compute_epoch_at_slot(active_header.slot))  # noqa: F821
    assert update_period in (finalized_period, finalized_period + 1)

    # Finality proof against the attested header's state
    if not is_finality_update(update):
        assert update.finality_branch == [Bytes32() for _ in range(floorlog2(FINALIZED_ROOT_INDEX))]  # noqa: F821
    else:
        assert is_valid_merkle_branch(  # noqa: F821
            leaf=hash_tree_root(update.finalized_header),  # noqa: F821
            branch=update.finality_branch,
            depth=floorlog2(FINALIZED_ROOT_INDEX),
            index=get_subtree_index(FINALIZED_ROOT_INDEX),
            root=update.attested_header.state_root,
        )

    # Next-sync-committee proof when crossing a period
    if update_period == finalized_period:
        sync_committee = store.current_sync_committee
        assert update.next_sync_committee_branch == [
            Bytes32() for _ in range(floorlog2(NEXT_SYNC_COMMITTEE_INDEX))  # noqa: F821
        ]
    else:
        sync_committee = store.next_sync_committee
        assert is_valid_merkle_branch(  # noqa: F821
            leaf=hash_tree_root(update.next_sync_committee),  # noqa: F821
            branch=update.next_sync_committee_branch,
            depth=floorlog2(NEXT_SYNC_COMMITTEE_INDEX),
            index=get_subtree_index(NEXT_SYNC_COMMITTEE_INDEX),
            root=active_header.state_root,
        )

    sync_aggregate = update.sync_aggregate
    assert sum(sync_aggregate.sync_committee_bits) >= MIN_SYNC_COMMITTEE_PARTICIPANTS  # noqa: F821

    participant_pubkeys = [
        pubkey for (bit, pubkey) in zip(sync_aggregate.sync_committee_bits, sync_committee.pubkeys)
        if bit
    ]
    domain = compute_domain(DOMAIN_SYNC_COMMITTEE, update.fork_version, genesis_validators_root)  # noqa: F821
    signing_root = compute_signing_root(update.attested_header, domain)  # noqa: F821
    assert bls.FastAggregateVerify(  # noqa: F821
        participant_pubkeys, signing_root, sync_aggregate.sync_committee_signature
    )


def apply_light_client_update(store: LightClientStore, update: LightClientUpdate) -> None:
    active_header = get_active_header(update)
    finalized_period = compute_sync_committee_period(compute_epoch_at_slot(store.finalized_header.slot))  # noqa: F821
    update_period = compute_sync_committee_period(compute_epoch_at_slot(active_header.slot))  # noqa: F821
    if update_period == finalized_period + 1:
        store.current_sync_committee = store.next_sync_committee
        store.next_sync_committee = update.next_sync_committee
    store.finalized_header = active_header
    if store.finalized_header.slot > store.optimistic_header.slot:
        store.optimistic_header = store.finalized_header


def process_light_client_update(store: LightClientStore, update: LightClientUpdate,
                                current_slot, genesis_validators_root) -> None:
    validate_light_client_update(store, update, current_slot, genesis_validators_root)

    sync_committee_bits = update.sync_aggregate.sync_committee_bits

    # Track best update for the forced-timeout path
    if (
        store.best_valid_update is None
        or sum(sync_committee_bits) > sum(store.best_valid_update.sync_aggregate.sync_committee_bits)
    ):
        store.best_valid_update = update

    store.current_max_active_participants = max(
        store.current_max_active_participants, sum(sync_committee_bits)
    )

    if (
        sum(sync_committee_bits) > get_safety_threshold(store)
        and update.attested_header.slot > store.optimistic_header.slot
    ):
        store.optimistic_header = update.attested_header

    if (
        sum(sync_committee_bits) * 3 >= len(sync_committee_bits) * 2
        and is_finality_update(update)
    ):
        # Normal 2/3-threshold update
        apply_light_client_update(store, update)
        store.best_valid_update = None


# ---------------------------------------------------------------------------
# Validator guide: sync committee duties (altair/validator.md)
# ---------------------------------------------------------------------------

class SyncCommitteeMessage(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    beacon_block_root: Root  # noqa: F821
    validator_index: ValidatorIndex  # noqa: F821
    signature: BLSSignature  # noqa: F821


class SyncCommitteeContribution(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    beacon_block_root: Root  # noqa: F821
    subcommittee_index: uint64  # noqa: F821
    aggregation_bits: Bitvector[SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT]  # noqa: F821
    signature: BLSSignature  # noqa: F821


class ContributionAndProof(Container):  # noqa: F821
    aggregator_index: ValidatorIndex  # noqa: F821
    contribution: SyncCommitteeContribution
    selection_proof: BLSSignature  # noqa: F821


class SignedContributionAndProof(Container):  # noqa: F821
    message: ContributionAndProof
    signature: BLSSignature  # noqa: F821


class SyncAggregatorSelectionData(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    subcommittee_index: uint64  # noqa: F821


def compute_sync_committee_period(epoch) -> int:
    return epoch // EPOCHS_PER_SYNC_COMMITTEE_PERIOD  # noqa: F821


def is_assigned_to_sync_committee(state: "BeaconState", epoch, validator_index) -> bool:
    sync_committee_period = compute_sync_committee_period(epoch)
    current_epoch = get_current_epoch(state)  # noqa: F821
    current_sync_committee_period = compute_sync_committee_period(current_epoch)
    next_sync_committee_period = current_sync_committee_period + 1
    assert sync_committee_period in (current_sync_committee_period, next_sync_committee_period)

    pubkey = state.validators[validator_index].pubkey
    if sync_committee_period == current_sync_committee_period:
        return pubkey in state.current_sync_committee.pubkeys
    return pubkey in state.next_sync_committee.pubkeys


def process_sync_committee_contributions(block, contributions) -> None:
    """Fold contributions into the block's SyncAggregate
    (altair/validator.md:227)."""
    sync_aggregate = SyncAggregate()
    signatures = []
    sync_subcommittee_size = SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT  # noqa: F821

    for contribution in contributions:
        subcommittee_index = contribution.subcommittee_index
        for index, participated in enumerate(contribution.aggregation_bits):
            if participated:
                participant_index = sync_subcommittee_size * subcommittee_index + index
                sync_aggregate.sync_committee_bits[participant_index] = True
        signatures.append(contribution.signature)

    sync_aggregate.sync_committee_signature = bls.Aggregate(signatures)  # noqa: F821
    block.body.sync_aggregate = sync_aggregate


def get_sync_committee_message(state: "BeaconState", block_root, validator_index, privkey):
    epoch = get_current_epoch(state)  # noqa: F821
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE, epoch)  # noqa: F821
    signing_root = compute_signing_root(Root(block_root), domain)  # noqa: F821
    signature = bls.Sign(privkey, signing_root)  # noqa: F821
    return SyncCommitteeMessage(
        slot=state.slot,
        beacon_block_root=block_root,
        validator_index=validator_index,
        signature=signature,
    )


def get_sync_subcommittee_pubkeys(state: "BeaconState", subcommittee_index):
    """The pubkey slice a gossip subnet's contributions must come from
    (altair/p2p-interface.md:125-137): committees assigned to a slot sign
    for slot-1, hence the period-boundary next-committee exception."""
    next_slot_epoch = compute_epoch_at_slot(Slot(state.slot + 1))  # noqa: F821
    if compute_sync_committee_period(get_current_epoch(state)) == compute_sync_committee_period(next_slot_epoch):  # noqa: F821
        sync_committee = state.current_sync_committee
    else:
        sync_committee = state.next_sync_committee

    sync_subcommittee_size = SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT  # noqa: F821
    start = int(subcommittee_index) * sync_subcommittee_size
    return [sync_committee.pubkeys[i] for i in range(start, start + sync_subcommittee_size)]


def compute_subnets_for_sync_committee(state: "BeaconState", validator_index):
    next_slot_epoch = compute_epoch_at_slot(Slot(state.slot + 1))  # noqa: F821
    if compute_sync_committee_period(get_current_epoch(state)) == compute_sync_committee_period(next_slot_epoch):  # noqa: F821
        sync_committee = state.current_sync_committee
    else:
        sync_committee = state.next_sync_committee

    target_pubkey = state.validators[validator_index].pubkey
    sync_committee_indices = [
        index for index, pubkey in enumerate(sync_committee.pubkeys) if pubkey == target_pubkey
    ]
    return set(
        uint64(index // (SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT))  # noqa: F821
        for index in sync_committee_indices
    )


def get_sync_committee_selection_proof(state: "BeaconState", slot, subcommittee_index, privkey):
    domain = get_domain(state, DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF, compute_epoch_at_slot(slot))  # noqa: F821
    signing_data = SyncAggregatorSelectionData(slot=slot, subcommittee_index=subcommittee_index)
    signing_root = compute_signing_root(signing_data, domain)  # noqa: F821
    return bls.Sign(privkey, signing_root)  # noqa: F821


def is_sync_committee_aggregator(signature) -> bool:
    modulo = max(
        1, SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT // TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE  # noqa: F821
    )
    return bytes_to_uint64(hash(signature)[0:8]) % modulo == 0  # noqa: F821


def get_contribution_and_proof(state: "BeaconState", aggregator_index, contribution, privkey):
    selection_proof = get_sync_committee_selection_proof(
        state, contribution.slot, contribution.subcommittee_index, privkey
    )
    return ContributionAndProof(
        aggregator_index=aggregator_index,
        contribution=contribution,
        selection_proof=selection_proof,
    )


def get_contribution_and_proof_signature(state: "BeaconState", contribution_and_proof, privkey):
    contribution = contribution_and_proof.contribution
    domain = get_domain(state, DOMAIN_CONTRIBUTION_AND_PROOF, compute_epoch_at_slot(contribution.slot))  # noqa: F821
    signing_root = compute_signing_root(contribution_and_proof, domain)  # noqa: F821
    return bls.Sign(privkey, signing_root)  # noqa: F821
