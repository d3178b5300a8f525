"""Genesis state factory for tests (ref: test/helpers/genesis.py)."""
from __future__ import annotations

from .constants import is_post_altair, is_post_bellatrix
from .keys import pubkeys


def mock_withdrawal_credentials(spec, validator_index: int) -> bytes:
    pubkey = pubkeys[validator_index]
    return bytes(spec.BLS_WITHDRAWAL_PREFIX) + spec.hash(pubkey)[1:]


def build_mock_validator(spec, i: int, balance: int):
    validator = spec.Validator(
        pubkey=pubkeys[i],
        withdrawal_credentials=mock_withdrawal_credentials(spec, i),
        activation_eligibility_epoch=spec.FAR_FUTURE_EPOCH,
        activation_epoch=spec.FAR_FUTURE_EPOCH,
        exit_epoch=spec.FAR_FUTURE_EPOCH,
        withdrawable_epoch=spec.FAR_FUTURE_EPOCH,
        effective_balance=min(
            balance - balance % spec.EFFECTIVE_BALANCE_INCREMENT, spec.MAX_EFFECTIVE_BALANCE
        ),
    )
    if hasattr(validator, "fully_withdrawn_epoch"):  # capella+
        validator.fully_withdrawn_epoch = spec.FAR_FUTURE_EPOCH
    return validator


def _fork_versions(spec):
    """(previous_version, current_version) the test genesis state should
    carry for the spec's fork (ref genesis.py:20-40)."""
    cfg = spec.config
    by_fork = {
        "phase0": (cfg.GENESIS_FORK_VERSION, cfg.GENESIS_FORK_VERSION),
        "altair": (cfg.GENESIS_FORK_VERSION, cfg.ALTAIR_FORK_VERSION),
        "bellatrix": (cfg.ALTAIR_FORK_VERSION, cfg.BELLATRIX_FORK_VERSION),
        "capella": (cfg.BELLATRIX_FORK_VERSION, cfg.CAPELLA_FORK_VERSION),
    }
    return by_fork[spec.fork]


def create_genesis_state(spec, validator_balances, activation_threshold):
    deposit_root = b"\x42" * 32
    eth1_block_hash = b"\xda" * 32
    previous_version, current_version = _fork_versions(spec)

    state = spec.BeaconState(
        genesis_time=0,
        eth1_deposit_index=len(validator_balances),
        eth1_data=spec.Eth1Data(
            deposit_root=deposit_root,
            deposit_count=len(validator_balances),
            block_hash=eth1_block_hash,
        ),
        fork=spec.Fork(
            previous_version=previous_version,
            current_version=current_version,
            epoch=spec.GENESIS_EPOCH,
        ),
        latest_block_header=spec.BeaconBlockHeader(
            body_root=spec.hash_tree_root(spec.BeaconBlockBody())
        ),
        randao_mixes=[eth1_block_hash] * spec.EPOCHS_PER_HISTORICAL_VECTOR,
    )

    # Seed the registry
    for index, balance in enumerate(validator_balances):
        validator = build_mock_validator(spec, index, balance)
        state.validators.append(validator)
        state.balances.append(balance)
        if validator.effective_balance >= activation_threshold:
            validator.activation_eligibility_epoch = spec.GENESIS_EPOCH
            validator.activation_epoch = spec.GENESIS_EPOCH

    state.genesis_validators_root = spec.hash_tree_root(state.validators)

    if is_post_altair(spec):
        # Participation/inactivity tracking + initial sync committees
        state.previous_epoch_participation = [spec.ParticipationFlags(0)] * len(state.validators)
        state.current_epoch_participation = [spec.ParticipationFlags(0)] * len(state.validators)
        state.inactivity_scores = [spec.uint64(0)] * len(state.validators)
        state.current_sync_committee = spec.get_next_sync_committee(state)
        state.next_sync_committee = spec.get_next_sync_committee(state)

    if is_post_bellatrix(spec):
        state.latest_execution_payload_header = spec.ExecutionPayloadHeader()

    return state
