"""Compile-time preset bundles (ref: presets/{mainnet,minimal}/*.yaml).

Values are the normative eth2 constants at spec v1.1.10. Stored as Python
dicts (keyed per fork so fork deltas stay deltas, mirroring the one-YAML-
file-per-fork layout) rather than YAML — the builder consumes them
directly and no YAML dependency is needed at import time.
"""
from __future__ import annotations

from typing import Dict

# -- mainnet -----------------------------------------------------------------

_MAINNET_PHASE0 = dict(
    # Misc (presets/mainnet/phase0.yaml:6-17)
    MAX_COMMITTEES_PER_SLOT=2**6,
    TARGET_COMMITTEE_SIZE=2**7,
    MAX_VALIDATORS_PER_COMMITTEE=2**11,
    SHUFFLE_ROUND_COUNT=90,
    HYSTERESIS_QUOTIENT=4,
    HYSTERESIS_DOWNWARD_MULTIPLIER=1,
    HYSTERESIS_UPWARD_MULTIPLIER=5,
    # Fork choice
    SAFE_SLOTS_TO_UPDATE_JUSTIFIED=2**3,
    # Gwei values
    MIN_DEPOSIT_AMOUNT=10**9,
    MAX_EFFECTIVE_BALANCE=32 * 10**9,
    EFFECTIVE_BALANCE_INCREMENT=10**9,
    # Time parameters
    MIN_ATTESTATION_INCLUSION_DELAY=1,
    SLOTS_PER_EPOCH=2**5,
    MIN_SEED_LOOKAHEAD=1,
    MAX_SEED_LOOKAHEAD=2**2,
    EPOCHS_PER_ETH1_VOTING_PERIOD=2**6,
    SLOTS_PER_HISTORICAL_ROOT=2**13,
    MIN_EPOCHS_TO_INACTIVITY_PENALTY=2**2,
    # State list lengths
    EPOCHS_PER_HISTORICAL_VECTOR=2**16,
    EPOCHS_PER_SLASHINGS_VECTOR=2**13,
    HISTORICAL_ROOTS_LIMIT=2**24,
    VALIDATOR_REGISTRY_LIMIT=2**40,
    # Reward and penalty quotients
    BASE_REWARD_FACTOR=2**6,
    WHISTLEBLOWER_REWARD_QUOTIENT=2**9,
    PROPOSER_REWARD_QUOTIENT=2**3,
    INACTIVITY_PENALTY_QUOTIENT=2**26,
    MIN_SLASHING_PENALTY_QUOTIENT=2**7,
    PROPORTIONAL_SLASHING_MULTIPLIER=1,
    # Max operations per block
    MAX_PROPOSER_SLASHINGS=2**4,
    MAX_ATTESTER_SLASHINGS=2**1,
    MAX_ATTESTATIONS=2**7,
    MAX_DEPOSITS=2**4,
    MAX_VOLUNTARY_EXITS=2**4,
)

_MAINNET_ALTAIR = dict(
    # Updated penalties (presets/mainnet/altair.yaml:5-11)
    INACTIVITY_PENALTY_QUOTIENT_ALTAIR=3 * 2**24,
    MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR=2**6,
    PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR=2,
    # Sync committee
    SYNC_COMMITTEE_SIZE=2**9,
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD=2**8,
    # Sync protocol
    MIN_SYNC_COMMITTEE_PARTICIPANTS=1,
    UPDATE_TIMEOUT=2**5 * 2**8,  # SLOTS_PER_EPOCH * EPOCHS_PER_SYNC_COMMITTEE_PERIOD
)

_MAINNET_BELLATRIX = dict(
    # Updated penalties (presets/mainnet/bellatrix.yaml:5-11)
    INACTIVITY_PENALTY_QUOTIENT_BELLATRIX=2**24,
    MIN_SLASHING_PENALTY_QUOTIENT_BELLATRIX=2**5,
    PROPORTIONAL_SLASHING_MULTIPLIER_BELLATRIX=3,
    # Execution
    MAX_BYTES_PER_TRANSACTION=2**30,
    MAX_TRANSACTIONS_PER_PAYLOAD=2**20,
    BYTES_PER_LOGS_BLOOM=2**8,
    MAX_EXTRA_DATA_BYTES=2**5,
)

# Capella preset file is empty at v1.1.10 (presets/mainnet/capella.yaml);
# the withdrawal-related sizes live in the capella spec draft itself and are
# supplied here so containers can be sized.
_MAINNET_CAPELLA = dict(
    MAX_BLS_TO_EXECUTION_CHANGES=2**4,
    MAX_WITHDRAWALS_PER_PAYLOAD=2**4,
    WITHDRAWALS_QUEUE_LIMIT=2**40,
)

_MAINNET_CUSTODY = dict(
    # presets/mainnet/custody_game.yaml
    RANDAO_PENALTY_EPOCHS=2**1,
    EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS=2**15,
    EPOCHS_PER_CUSTODY_PERIOD=2**14,
    CUSTODY_PERIOD_TO_RANDAO_PADDING=2**11,
    MAX_CHUNK_CHALLENGE_DELAY=2**15,
    MAX_CUSTODY_KEY_REVEALS=2**8,
    MAX_EARLY_DERIVED_SECRET_REVEALS=1,
    MAX_CUSTODY_CHUNK_CHALLENGES=2**2,
    MAX_CUSTODY_CHUNK_CHALLENGE_RESP=2**4,
    MAX_CUSTODY_SLASHINGS=1,
    EARLY_DERIVED_SECRET_REVEAL_SLOT_REWARD_MULTIPLE=2,
    MINOR_REWARD_QUOTIENT=2**8,
)

_MAINNET_SHARDING = dict(
    # presets/mainnet/sharding.yaml
    MAX_SHARDS=2**10,
    INITIAL_ACTIVE_SHARDS=2**6,
    SAMPLE_PRICE_ADJUSTMENT_COEFFICIENT=2**3,
    MAX_SHARD_PROPOSER_SLASHINGS=2**4,
    MAX_SHARD_HEADERS_PER_SHARD=4,
    SHARD_STATE_MEMORY_SLOTS=2**8,
    BLOB_BUILDER_REGISTRY_LIMIT=2**40,
    MAX_SAMPLES_PER_BLOCK=2**11,
    TARGET_SAMPLES_PER_BLOCK=2**10,
    MAX_SAMPLE_PRICE=2**33,
    MIN_SAMPLE_PRICE=2**3,
    # development KZG setup size = MAX_DEGREE+1 (the reference leaves the
    # setup undefined, sharding/beacon-chain.md:170-173); mainnet covers
    # the full MAX_SAMPLES_PER_BLOCK * POINTS_PER_SAMPLE degree bound
    KZG_SETUP_SIZE=2**14,
)

_MAINNET_EIP4844 = dict(
    # eip4844/beacon-chain.md:54 + p2p-interface.md:40
    FIELD_ELEMENTS_PER_BLOB=4096,
    MAX_BLOBS_PER_BLOCK=2**4,
)

# -- minimal (only keys that differ from mainnet) ----------------------------

_MINIMAL_PHASE0 = dict(
    _MAINNET_PHASE0,
    MAX_COMMITTEES_PER_SLOT=4,
    TARGET_COMMITTEE_SIZE=4,
    SHUFFLE_ROUND_COUNT=10,
    SAFE_SLOTS_TO_UPDATE_JUSTIFIED=2,
    SLOTS_PER_EPOCH=8,
    EPOCHS_PER_ETH1_VOTING_PERIOD=4,
    SLOTS_PER_HISTORICAL_ROOT=64,
    EPOCHS_PER_HISTORICAL_VECTOR=64,
    EPOCHS_PER_SLASHINGS_VECTOR=64,
    INACTIVITY_PENALTY_QUOTIENT=2**25,
    MIN_SLASHING_PENALTY_QUOTIENT=64,
    PROPORTIONAL_SLASHING_MULTIPLIER=2,
)

_MINIMAL_ALTAIR = dict(
    _MAINNET_ALTAIR,
    SYNC_COMMITTEE_SIZE=32,
    EPOCHS_PER_SYNC_COMMITTEE_PERIOD=8,
    UPDATE_TIMEOUT=64,
)

_MINIMAL_BELLATRIX = dict(_MAINNET_BELLATRIX)

_MINIMAL_CAPELLA = dict(_MAINNET_CAPELLA)

_MINIMAL_CUSTODY = dict(
    _MAINNET_CUSTODY,
    EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS=64,
    EPOCHS_PER_CUSTODY_PERIOD=32,
    CUSTODY_PERIOD_TO_RANDAO_PADDING=8,
    MAX_CHUNK_CHALLENGE_DELAY=64,
    MAX_CUSTODY_CHUNK_CHALLENGES=2,
    MAX_CUSTODY_CHUNK_CHALLENGE_RESP=8,
)

_MINIMAL_SHARDING = dict(
    _MAINNET_SHARDING,
    MAX_SHARDS=8,
    INITIAL_ACTIVE_SHARDS=2,
    MAX_SHARD_PROPOSER_SLASHINGS=4,
    KZG_SETUP_SIZE=64,  # fast dev setup; degree bound 64 points
)

_MINIMAL_EIP4844 = dict(
    _MAINNET_EIP4844,
    FIELD_ELEMENTS_PER_BLOB=4,  # tiny blobs for fast minimal-preset tests
)

PRESETS: Dict[str, Dict[str, Dict[str, int]]] = {
    "mainnet": {
        "phase0": _MAINNET_PHASE0,
        "altair": _MAINNET_ALTAIR,
        "bellatrix": _MAINNET_BELLATRIX,
        "capella": _MAINNET_CAPELLA,
        "custody_game": _MAINNET_CUSTODY,
        "sharding": _MAINNET_SHARDING,
        "eip4844": _MAINNET_EIP4844,
    },
    "minimal": {
        "phase0": _MINIMAL_PHASE0,
        "altair": _MINIMAL_ALTAIR,
        "bellatrix": _MINIMAL_BELLATRIX,
        "capella": _MINIMAL_CAPELLA,
        "custody_game": _MINIMAL_CUSTODY,
        "sharding": _MINIMAL_SHARDING,
        "eip4844": _MINIMAL_EIP4844,
    },
}


def preset_for(preset_name: str, forks) -> Dict[str, int]:
    """Merged preset-variable dict for the given fork chain (a list like
    ["phase0", "altair"]), mirroring setup.py:782-792's per-fork YAML load."""
    bundle = PRESETS[preset_name]
    out: Dict[str, int] = {}
    for fork in forks:
        out.update(bundle.get(fork, {}))
    return out
