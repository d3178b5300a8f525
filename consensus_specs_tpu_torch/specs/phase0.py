"""Phase0 spec source (delta root).

Covers the executable surface of specs/phase0/{beacon-chain,fork-choice,
validator,weak-subjectivity}.md at v1.1.10. Executed by specs.build into a
flat (fork, preset) module: preset constants and ``config`` are injected
into the namespace before exec, so bare preset names resolve at build time.

Implementation notes:
- Shuffling is computed as a whole permutation per (seed, count) with the
  swap-or-not rounds vectorized in numpy and every round's source blocks
  hashed in ONE batched call through the pluggable hasher
  (ssz.hashing.hash_many) — on device when the device hasher is installed.
  The scalar compute_shuffled_index is kept for spec parity and the
  shuffling test-vector format (ref: beacon-chain.md:760-785).
- Reward/penalty component helpers share O(1) total-balance precomputation
  instead of the reference's per-index recomputation (beacon-chain.md:
  1404-1566); results are bit-identical.
- All signature checks route through the switchable bls facade
  (ref: eth2spec/utils/bls.py:6-44).
- get_active_validator_indices is memoized on (registry root, epoch), as
  clients keep committee caches; results are bit-identical.
"""
# ---- injected by the builder: preset constants, `config`, fork name ----
import math as _math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Set, Tuple  # noqa: F401 (spec namespace: fork deltas exec here)

import numpy as np

from consensus_specs_tpu_torch import ssz  # noqa: F401 (spec namespace)
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.ssz import (  # noqa: F401 (spec namespace: later forks use the full type menagerie)
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes1,
    Bytes4,
    Bytes8,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    Union,
    Vector,
    boolean,
    byte,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
from consensus_specs_tpu_torch.ssz import hash_tree_root, serialize, copy  # noqa: F401
from consensus_specs_tpu_torch.ssz import get_generalized_index, get_generalized_index_length  # noqa: F401
from consensus_specs_tpu_torch.ssz.hashing import sha256 as _sha256, sha256_many_small


# ---------------------------------------------------------------------------
# Custom types (beacon-chain.md:260-295)
# ---------------------------------------------------------------------------

class Slot(uint64):
    pass


class Epoch(uint64):
    pass


class CommitteeIndex(uint64):
    pass


class ValidatorIndex(uint64):
    pass


class Gwei(uint64):
    pass


class Root(Bytes32):
    pass


class Hash32(Bytes32):
    pass


class Version(Bytes4):
    pass


class DomainType(Bytes4):
    pass


class ForkDigest(Bytes4):
    pass


class Domain(Bytes32):
    pass


class BLSPubkey(Bytes48):
    pass


class BLSSignature(Bytes96):
    pass


# ---------------------------------------------------------------------------
# Constants (beacon-chain.md:297-330; fork-choice.md:71-80; validator.md:70-80;
# weak-subjectivity.md:45-55)
# ---------------------------------------------------------------------------

GENESIS_SLOT = Slot(0)
GENESIS_EPOCH = Epoch(0)
FAR_FUTURE_EPOCH = Epoch(2**64 - 1)
BASE_REWARDS_PER_EPOCH = uint64(4)
DEPOSIT_CONTRACT_TREE_DEPTH = uint64(2**5)
JUSTIFICATION_BITS_LENGTH = uint64(4)
ENDIANNESS = "little"

BLS_WITHDRAWAL_PREFIX = Bytes1(b"\x00")
ETH1_ADDRESS_WITHDRAWAL_PREFIX = Bytes1(b"\x01")

DOMAIN_BEACON_PROPOSER = DomainType(b"\x00\x00\x00\x00")
DOMAIN_BEACON_ATTESTER = DomainType(b"\x01\x00\x00\x00")
DOMAIN_RANDAO = DomainType(b"\x02\x00\x00\x00")
DOMAIN_DEPOSIT = DomainType(b"\x03\x00\x00\x00")
DOMAIN_VOLUNTARY_EXIT = DomainType(b"\x04\x00\x00\x00")
DOMAIN_SELECTION_PROOF = DomainType(b"\x05\x00\x00\x00")
DOMAIN_AGGREGATE_AND_PROOF = DomainType(b"\x06\x00\x00\x00")

# Fork choice (fork-choice.md:71-80)
INTERVALS_PER_SLOT = uint64(3)

# Validator guide (validator.md:70-80)
TARGET_AGGREGATORS_PER_COMMITTEE = 2**4
RANDOM_SUBNETS_PER_VALIDATOR = 2**0
EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION = 2**8
ATTESTATION_SUBNET_COUNT = 64

# Weak subjectivity (weak-subjectivity.md:45-55)
ETH_TO_GWEI = uint64(10**9)
SAFETY_DECAY = uint64(10)


# ---------------------------------------------------------------------------
# Containers (beacon-chain.md:330-583; validator.md:111-125; validator.md Eth1Block)
# ---------------------------------------------------------------------------

class Fork(Container):
    previous_version: Version
    current_version: Version
    epoch: Epoch


class ForkData(Container):
    current_version: Version
    genesis_validators_root: Root


class Checkpoint(Container):
    epoch: Epoch
    root: Root


class Validator(Container):
    pubkey: BLSPubkey
    withdrawal_credentials: Bytes32
    effective_balance: Gwei
    slashed: boolean
    activation_eligibility_epoch: Epoch
    activation_epoch: Epoch
    exit_epoch: Epoch
    withdrawable_epoch: Epoch


class AttestationData(Container):
    slot: Slot
    index: CommitteeIndex
    beacon_block_root: Root
    source: Checkpoint
    target: Checkpoint


class IndexedAttestation(Container):
    attesting_indices: List[ValidatorIndex, MAX_VALIDATORS_PER_COMMITTEE]  # noqa: F821
    data: AttestationData
    signature: BLSSignature


class PendingAttestation(Container):
    aggregation_bits: Bitlist[MAX_VALIDATORS_PER_COMMITTEE]  # noqa: F821
    data: AttestationData
    inclusion_delay: Slot
    proposer_index: ValidatorIndex


class Eth1Data(Container):
    deposit_root: Root
    deposit_count: uint64
    block_hash: Hash32


class HistoricalBatch(Container):
    block_roots: Vector[Root, SLOTS_PER_HISTORICAL_ROOT]  # noqa: F821
    state_roots: Vector[Root, SLOTS_PER_HISTORICAL_ROOT]  # noqa: F821


class DepositMessage(Container):
    pubkey: BLSPubkey
    withdrawal_credentials: Bytes32
    amount: Gwei


class DepositData(Container):
    pubkey: BLSPubkey
    withdrawal_credentials: Bytes32
    amount: Gwei
    signature: BLSSignature


class BeaconBlockHeader(Container):
    slot: Slot
    proposer_index: ValidatorIndex
    parent_root: Root
    state_root: Root
    body_root: Root


class SigningData(Container):
    object_root: Root
    domain: Domain


class SignedBeaconBlockHeader(Container):
    message: BeaconBlockHeader
    signature: BLSSignature


class ProposerSlashing(Container):
    signed_header_1: SignedBeaconBlockHeader
    signed_header_2: SignedBeaconBlockHeader


class AttesterSlashing(Container):
    attestation_1: IndexedAttestation
    attestation_2: IndexedAttestation


class Attestation(Container):
    aggregation_bits: Bitlist[MAX_VALIDATORS_PER_COMMITTEE]  # noqa: F821
    data: AttestationData
    signature: BLSSignature


class Deposit(Container):
    proof: Vector[Bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1]
    data: DepositData


class VoluntaryExit(Container):
    epoch: Epoch
    validator_index: ValidatorIndex


class SignedVoluntaryExit(Container):
    message: VoluntaryExit
    signature: BLSSignature


class BeaconBlockBody(Container):
    randao_reveal: BLSSignature
    eth1_data: Eth1Data
    graffiti: Bytes32
    proposer_slashings: List[ProposerSlashing, MAX_PROPOSER_SLASHINGS]  # noqa: F821
    attester_slashings: List[AttesterSlashing, MAX_ATTESTER_SLASHINGS]  # noqa: F821
    attestations: List[Attestation, MAX_ATTESTATIONS]  # noqa: F821
    deposits: List[Deposit, MAX_DEPOSITS]  # noqa: F821
    voluntary_exits: List[SignedVoluntaryExit, MAX_VOLUNTARY_EXITS]  # noqa: F821


class BeaconBlock(Container):
    slot: Slot
    proposer_index: ValidatorIndex
    parent_root: Root
    state_root: Root
    body: BeaconBlockBody


class SignedBeaconBlock(Container):
    message: BeaconBlock
    signature: BLSSignature


class BeaconState(Container):
    # Versioning
    genesis_time: uint64
    genesis_validators_root: Root
    slot: Slot
    fork: Fork
    # History
    latest_block_header: BeaconBlockHeader
    block_roots: Vector[Root, SLOTS_PER_HISTORICAL_ROOT]  # noqa: F821
    state_roots: Vector[Root, SLOTS_PER_HISTORICAL_ROOT]  # noqa: F821
    historical_roots: List[Root, HISTORICAL_ROOTS_LIMIT]  # noqa: F821
    # Eth1
    eth1_data: Eth1Data
    eth1_data_votes: List[Eth1Data, EPOCHS_PER_ETH1_VOTING_PERIOD * SLOTS_PER_EPOCH]  # noqa: F821
    eth1_deposit_index: uint64
    # Registry
    validators: List[Validator, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    balances: List[Gwei, VALIDATOR_REGISTRY_LIMIT]  # noqa: F821
    # Randomness
    randao_mixes: Vector[Bytes32, EPOCHS_PER_HISTORICAL_VECTOR]  # noqa: F821
    # Slashings
    slashings: Vector[Gwei, EPOCHS_PER_SLASHINGS_VECTOR]  # noqa: F821
    # Attestations
    previous_epoch_attestations: List[PendingAttestation, MAX_ATTESTATIONS * SLOTS_PER_EPOCH]  # noqa: F821
    current_epoch_attestations: List[PendingAttestation, MAX_ATTESTATIONS * SLOTS_PER_EPOCH]  # noqa: F821
    # Finality
    justification_bits: Bitvector[JUSTIFICATION_BITS_LENGTH]
    previous_justified_checkpoint: Checkpoint
    current_justified_checkpoint: Checkpoint
    finalized_checkpoint: Checkpoint


# Validator-guide containers (validator.md:111-125 + Eth1Block)

class Eth1Block(Container):
    timestamp: uint64
    deposit_root: Root
    deposit_count: uint64


class AggregateAndProof(Container):
    aggregator_index: ValidatorIndex
    aggregate: Attestation
    selection_proof: BLSSignature


class SignedAggregateAndProof(Container):
    message: AggregateAndProof
    signature: BLSSignature


# ---------------------------------------------------------------------------
# Math & crypto helpers (beacon-chain.md:589-760)
# ---------------------------------------------------------------------------

def hash(data: bytes) -> Bytes32:  # noqa: A001  (spec name)
    """SHA-256 (eth2spec/utils/hash_function.py:8)."""
    return Bytes32(_sha256(bytes(data)))


def integer_squareroot(n: uint64) -> uint64:
    """Largest x with x*x <= n (beacon-chain.md:597)."""
    return uint64(_math.isqrt(int(n)))


def xor(bytes_1: Bytes32, bytes_2: Bytes32) -> Bytes32:
    """Bytewise xor (beacon-chain.md:612)."""
    return Bytes32(bytes(a ^ b for a, b in zip(bytes_1, bytes_2)))


def uint_to_bytes(n) -> bytes:
    """Little-endian serialization at the uint's own width
    (ssz_impl.uint_to_bytes)."""
    return n.encode_bytes()


def bytes_to_uint64(data: bytes) -> uint64:
    """Little-endian deserialization (beacon-chain.md:622)."""
    return uint64(int.from_bytes(data, ENDIANNESS))


# ---------------------------------------------------------------------------
# Predicates (beacon-chain.md:630-760)
# ---------------------------------------------------------------------------

def is_active_validator(validator: Validator, epoch: Epoch) -> bool:
    return validator.activation_epoch <= epoch < validator.exit_epoch


def is_eligible_for_activation_queue(validator: Validator) -> bool:
    return (
        validator.activation_eligibility_epoch == FAR_FUTURE_EPOCH
        and validator.effective_balance == MAX_EFFECTIVE_BALANCE  # noqa: F821
    )


def is_eligible_for_activation(state: "BeaconState", validator: Validator) -> bool:
    return (
        validator.activation_eligibility_epoch <= state.finalized_checkpoint.epoch
        and validator.activation_epoch == FAR_FUTURE_EPOCH
    )


def is_slashable_validator(validator: Validator, epoch: Epoch) -> bool:
    return (not validator.slashed) and (
        validator.activation_epoch <= epoch < validator.withdrawable_epoch
    )


def is_slashable_attestation_data(data_1: AttestationData, data_2: AttestationData) -> bool:
    """Double vote or surround vote (beacon-chain.md:706)."""
    return (
        # Double vote
        (data_1 != data_2 and data_1.target.epoch == data_2.target.epoch)
        # Surround vote
        or (data_1.source.epoch < data_2.source.epoch and data_2.target.epoch < data_1.target.epoch)
    )


def is_valid_indexed_attestation(state: "BeaconState", indexed_attestation: IndexedAttestation) -> bool:
    """Sorted-indices + aggregate signature check → bls.FastAggregateVerify
    (beacon-chain.md:724)."""
    indices = list(indexed_attestation.attesting_indices)
    if len(indices) == 0 or indices != sorted(set(indices)):
        return False
    pubkeys = [state.validators[i].pubkey for i in indices]
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, indexed_attestation.data.target.epoch)
    signing_root = compute_signing_root(indexed_attestation.data, domain)
    return bls.FastAggregateVerify(pubkeys, signing_root, indexed_attestation.signature)


def is_valid_merkle_branch(leaf: Bytes32, branch: Sequence[Bytes32], depth: uint64, index: uint64, root: Root) -> bool:
    """Fold the branch upward and compare (beacon-chain.md:742)."""
    node = bytes(leaf)
    for i in range(depth):
        if (int(index) >> i) & 1:
            node = _sha256(bytes(branch[i]) + node)
        else:
            node = _sha256(node + bytes(branch[i]))
    return node == bytes(root)


# ---------------------------------------------------------------------------
# Shuffling (beacon-chain.md:760-830) — batched swap-or-not
# ---------------------------------------------------------------------------

def compute_shuffled_index(index: uint64, index_count: uint64, seed: Bytes32) -> uint64:
    """Scalar 90-round swap-or-not shuffle of one index (beacon-chain.md:760).
    Kept for parity + the shuffling test-vector format; committee computation
    uses the batched permutation below."""
    assert index < index_count
    for current_round in range(SHUFFLE_ROUND_COUNT):  # noqa: F821
        pivot = bytes_to_uint64(hash(seed + uint_to_bytes(uint8(current_round)))[0:8]) % index_count
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = hash(
            seed
            + uint_to_bytes(uint8(current_round))
            + uint_to_bytes(uint32(position // 256))
        )
        byte = uint8(source[(position % 256) // 8])
        bit = (byte >> (position % 8)) % 2
        index = flip if bit else index
    return uint64(index)


_shuffle_cache: Dict[Tuple[bytes, int], np.ndarray] = {}


def _shuffle_permutation(index_count: int, seed: bytes) -> np.ndarray:
    """perm[i] == compute_shuffled_index(i, index_count, seed) for all i,
    with each round's hash sources computed in one batched hasher call."""
    n = int(index_count)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    key = (bytes(seed), n)
    cached = _shuffle_cache.get(key)
    if cached is not None:
        return cached
    rounds = int(SHUFFLE_ROUND_COUNT)  # noqa: F821
    n_blocks = (n + 255) // 256
    # ALL hashes any round will need are independent of the evolving
    # permutation — one batched call for pivots + every round's source rows.
    seed_b = bytes(seed)
    msgs = [seed_b + bytes([r]) for r in range(rounds)]
    msgs += [
        seed_b + bytes([r]) + b.to_bytes(4, "little")
        for r in range(rounds)
        for b in range(n_blocks)
    ]
    digests = sha256_many_small(msgs)
    pivots = [int.from_bytes(d[:8], "little") % n for d in digests[:rounds]]
    src = np.frombuffer(b"".join(digests[rounds:]), dtype=np.uint8).reshape(rounds, n_blocks, 32)

    idx = np.arange(n, dtype=np.int64)
    for r in range(rounds):
        flip = (pivots[r] + n - idx) % n
        pos = np.maximum(idx, flip)
        byte_vals = src[r, pos // 256, (pos % 256) // 8]
        bits = (byte_vals >> (pos % 8).astype(np.uint8)) & 1
        idx = np.where(bits.astype(bool), flip, idx)
    if len(_shuffle_cache) > 64:
        _shuffle_cache.clear()
    _shuffle_cache[key] = idx
    return idx


def compute_committee(indices: Sequence[ValidatorIndex], seed: Bytes32, index: uint64, count: uint64) -> Sequence[ValidatorIndex]:
    """Slice of the shuffled active set (beacon-chain.md:807).

    The per-element bound assert mirrors the reference's
    compute_shuffled_index(i, index_count) precondition (beacon-chain.md
    :760 `assert index < index_count`) — an out-of-range committee index
    must surface as the spec's AssertionError control flow, not an
    implementation IndexError from the batched permutation."""
    start = (len(indices) * int(index)) // int(count)
    end = (len(indices) * (int(index) + 1)) // int(count)
    perm = _shuffle_permutation(len(indices), seed)
    out = []
    for i in range(start, end):
        assert i < len(indices)
        out.append(indices[perm[i]])
    return out


def compute_proposer_index(state: "BeaconState", indices: Sequence[ValidatorIndex], seed: Bytes32) -> ValidatorIndex:
    """Effective-balance-biased candidate scan (beacon-chain.md:787)."""
    assert len(indices) > 0
    MAX_RANDOM_BYTE = 2**8 - 1
    total = uint64(len(indices))
    perm = _shuffle_permutation(len(indices), seed)
    i = uint64(0)
    while True:
        candidate_index = indices[perm[int(i % total)]]
        random_byte = hash(seed + uint_to_bytes(uint64(i // 32)))[i % 32]
        effective_balance = state.validators[candidate_index].effective_balance
        if effective_balance * MAX_RANDOM_BYTE >= MAX_EFFECTIVE_BALANCE * random_byte:  # noqa: F821
            return ValidatorIndex(candidate_index)
        i += 1


# ---------------------------------------------------------------------------
# Misc compute_* (beacon-chain.md:830-980)
# ---------------------------------------------------------------------------

def compute_epoch_at_slot(slot: Slot) -> Epoch:
    return Epoch(slot // SLOTS_PER_EPOCH)  # noqa: F821


def compute_start_slot_at_epoch(epoch: Epoch) -> Slot:
    return Slot(epoch * SLOTS_PER_EPOCH)  # noqa: F821


def compute_activation_exit_epoch(epoch: Epoch) -> Epoch:
    return Epoch(epoch + 1 + MAX_SEED_LOOKAHEAD)  # noqa: F821


def compute_fork_data_root(current_version: Version, genesis_validators_root: Root) -> Root:
    return Root(hash_tree_root(ForkData(
        current_version=current_version,
        genesis_validators_root=genesis_validators_root,
    )))


def compute_fork_digest(current_version: Version, genesis_validators_root: Root) -> ForkDigest:
    return ForkDigest(compute_fork_data_root(current_version, genesis_validators_root)[:4])


def compute_domain(domain_type: DomainType, fork_version: Optional[Version] = None, genesis_validators_root: Optional[Root] = None) -> Domain:
    if fork_version is None:
        fork_version = Version(config.GENESIS_FORK_VERSION)  # noqa: F821
    if genesis_validators_root is None:
        genesis_validators_root = Root()
    fork_data_root = compute_fork_data_root(fork_version, genesis_validators_root)
    return Domain(bytes(domain_type) + bytes(fork_data_root)[:28])


def compute_signing_root(ssz_object, domain: Domain) -> Root:
    return Root(hash_tree_root(SigningData(
        object_root=hash_tree_root(ssz_object),
        domain=domain,
    )))


# ---------------------------------------------------------------------------
# Accessors (beacon-chain.md:930-1120)
# ---------------------------------------------------------------------------

def get_current_epoch(state: "BeaconState") -> Epoch:
    return compute_epoch_at_slot(state.slot)


def get_previous_epoch(state: "BeaconState") -> Epoch:
    current_epoch = get_current_epoch(state)
    return GENESIS_EPOCH if current_epoch == GENESIS_EPOCH else Epoch(current_epoch - 1)


def get_block_root(state: "BeaconState", epoch: Epoch) -> Root:
    return get_block_root_at_slot(state, compute_start_slot_at_epoch(epoch))


def get_block_root_at_slot(state: "BeaconState", slot: Slot) -> Root:
    assert slot < state.slot <= slot + SLOTS_PER_HISTORICAL_ROOT  # noqa: F821
    return state.block_roots[slot % SLOTS_PER_HISTORICAL_ROOT]  # noqa: F821


def get_randao_mix(state: "BeaconState", epoch: Epoch) -> Bytes32:
    return state.randao_mixes[epoch % EPOCHS_PER_HISTORICAL_VECTOR]  # noqa: F821


_active_indices_cache: Dict[Tuple[bytes, int], Tuple[ValidatorIndex, ...]] = {}


def get_active_validator_indices(state: "BeaconState", epoch: Epoch) -> Sequence[ValidatorIndex]:
    """Memoized on (registry root, epoch): the active set is a function of
    exactly the registry's contents and the epoch, and the root pins the
    contents. Block processing asks for it several times per attestation;
    at a mainnet-size registry each uncached call is a full registry scan."""
    key = (state.validators.hash_tree_root(), int(epoch))
    active = _active_indices_cache.get(key)
    if active is None:
        active = tuple(ValidatorIndex(i) for i, v in enumerate(state.validators) if is_active_validator(v, epoch))
        if len(_active_indices_cache) > 64:
            _active_indices_cache.clear()
        _active_indices_cache[key] = active
    return list(active)


def get_validator_churn_limit(state: "BeaconState") -> uint64:
    active_validator_indices = get_active_validator_indices(state, get_current_epoch(state))
    return max(
        uint64(config.MIN_PER_EPOCH_CHURN_LIMIT),  # noqa: F821
        uint64(len(active_validator_indices) // config.CHURN_LIMIT_QUOTIENT),  # noqa: F821
    )


def get_seed(state: "BeaconState", epoch: Epoch, domain_type: DomainType) -> Bytes32:
    mix = get_randao_mix(state, Epoch(epoch + EPOCHS_PER_HISTORICAL_VECTOR - MIN_SEED_LOOKAHEAD - 1))  # noqa: F821
    return hash(bytes(domain_type) + uint_to_bytes(uint64(epoch)) + bytes(mix))


def get_committee_count_per_slot(state: "BeaconState", epoch: Epoch) -> uint64:
    return max(uint64(1), min(
        uint64(MAX_COMMITTEES_PER_SLOT),  # noqa: F821
        uint64(len(get_active_validator_indices(state, epoch)) // SLOTS_PER_EPOCH // TARGET_COMMITTEE_SIZE),  # noqa: F821
    ))


def get_beacon_committee(state: "BeaconState", slot: Slot, index: CommitteeIndex) -> Sequence[ValidatorIndex]:
    epoch = compute_epoch_at_slot(slot)
    committees_per_slot = get_committee_count_per_slot(state, epoch)
    return compute_committee(
        indices=get_active_validator_indices(state, epoch),
        seed=get_seed(state, epoch, DOMAIN_BEACON_ATTESTER),
        index=(slot % SLOTS_PER_EPOCH) * committees_per_slot + index,  # noqa: F821
        count=committees_per_slot * SLOTS_PER_EPOCH,  # noqa: F821
    )


def get_beacon_proposer_index(state: "BeaconState") -> ValidatorIndex:
    epoch = get_current_epoch(state)
    seed = hash(get_seed(state, epoch, DOMAIN_BEACON_PROPOSER) + uint_to_bytes(uint64(state.slot)))
    indices = get_active_validator_indices(state, epoch)
    return compute_proposer_index(state, indices, seed)


def get_total_balance(state: "BeaconState", indices: Set[ValidatorIndex]) -> Gwei:
    return Gwei(max(
        int(EFFECTIVE_BALANCE_INCREMENT),  # noqa: F821
        sum(int(state.validators[i].effective_balance) for i in indices),
    ))


def get_total_active_balance(state: "BeaconState") -> Gwei:
    return get_total_balance(state, set(get_active_validator_indices(state, get_current_epoch(state))))


def get_domain(state: "BeaconState", domain_type: DomainType, epoch: Optional[Epoch] = None) -> Domain:
    epoch = get_current_epoch(state) if epoch is None else epoch
    fork_version = state.fork.previous_version if epoch < state.fork.epoch else state.fork.current_version
    return compute_domain(domain_type, fork_version, state.genesis_validators_root)


def get_indexed_attestation(state: "BeaconState", attestation: Attestation) -> IndexedAttestation:
    attesting_indices = get_attesting_indices(state, attestation.data, attestation.aggregation_bits)
    return IndexedAttestation(
        attesting_indices=sorted(attesting_indices),
        data=attestation.data,
        signature=attestation.signature,
    )


def get_attesting_indices(state: "BeaconState", data: AttestationData, bits) -> Set[ValidatorIndex]:
    committee = get_beacon_committee(state, data.slot, data.index)
    return set(index for i, index in enumerate(committee) if bits[i])


# ---------------------------------------------------------------------------
# Mutators (beacon-chain.md:1100-1180)
# ---------------------------------------------------------------------------

def increase_balance(state: "BeaconState", index: ValidatorIndex, delta: Gwei) -> None:
    state.balances[index] = Gwei(state.balances[index] + delta)


def decrease_balance(state: "BeaconState", index: ValidatorIndex, delta: Gwei) -> None:
    state.balances[index] = Gwei(0 if delta > state.balances[index] else state.balances[index] - delta)


def initiate_validator_exit(state: "BeaconState", index: ValidatorIndex) -> None:
    """Queue an exit behind the churn limit (beacon-chain.md:1121)."""
    validator = state.validators[index]
    if validator.exit_epoch != FAR_FUTURE_EPOCH:
        return
    exit_epochs = [v.exit_epoch for v in state.validators if v.exit_epoch != FAR_FUTURE_EPOCH]
    exit_queue_epoch = max(exit_epochs + [compute_activation_exit_epoch(get_current_epoch(state))])
    exit_queue_churn = len([v for v in state.validators if v.exit_epoch == exit_queue_epoch])
    if exit_queue_churn >= get_validator_churn_limit(state):
        exit_queue_epoch += Epoch(1)
    validator.exit_epoch = exit_queue_epoch
    validator.withdrawable_epoch = Epoch(validator.exit_epoch + config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY)  # noqa: F821


def slash_validator(state: "BeaconState", slashed_index: ValidatorIndex, whistleblower_index: Optional[ValidatorIndex] = None) -> None:
    """Slash + proposer/whistleblower rewards (beacon-chain.md:1145)."""
    epoch = get_current_epoch(state)
    initiate_validator_exit(state, slashed_index)
    validator = state.validators[slashed_index]
    validator.slashed = True
    validator.withdrawable_epoch = max(validator.withdrawable_epoch, Epoch(epoch + EPOCHS_PER_SLASHINGS_VECTOR))  # noqa: F821
    state.slashings[epoch % EPOCHS_PER_SLASHINGS_VECTOR] += validator.effective_balance  # noqa: F821
    decrease_balance(state, slashed_index, validator.effective_balance // MIN_SLASHING_PENALTY_QUOTIENT)  # noqa: F821

    proposer_index = get_beacon_proposer_index(state)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = Gwei(validator.effective_balance // WHISTLEBLOWER_REWARD_QUOTIENT)  # noqa: F821
    proposer_reward = Gwei(whistleblower_reward // PROPOSER_REWARD_QUOTIENT)  # noqa: F821
    increase_balance(state, proposer_index, proposer_reward)
    increase_balance(state, whistleblower_index, Gwei(whistleblower_reward - proposer_reward))


# ---------------------------------------------------------------------------
# Genesis (beacon-chain.md:1180-1240)
# ---------------------------------------------------------------------------

def initialize_beacon_state_from_eth1(eth1_block_hash: Hash32, eth1_timestamp: uint64, deposits: Sequence[Deposit]) -> "BeaconState":
    fork = Fork(
        previous_version=config.GENESIS_FORK_VERSION,  # noqa: F821
        current_version=config.GENESIS_FORK_VERSION,  # noqa: F821
        epoch=GENESIS_EPOCH,
    )
    state = BeaconState(
        genesis_time=eth1_timestamp + config.GENESIS_DELAY,  # noqa: F821
        fork=fork,
        eth1_data=Eth1Data(block_hash=eth1_block_hash, deposit_count=uint64(len(deposits))),
        latest_block_header=BeaconBlockHeader(body_root=hash_tree_root(BeaconBlockBody())),
        randao_mixes=[eth1_block_hash] * EPOCHS_PER_HISTORICAL_VECTOR,  # noqa: F821
    )

    # Process deposits against an incrementally-growing deposit tree
    leaves = [deposit.data for deposit in deposits]
    for index, deposit in enumerate(deposits):
        deposit_data_list = List[DepositData, 2**DEPOSIT_CONTRACT_TREE_DEPTH](leaves[: index + 1])
        state.eth1_data.deposit_root = hash_tree_root(deposit_data_list)
        process_deposit(state, deposit)

    # Process activations
    for index, validator in enumerate(state.validators):
        balance = state.balances[index]
        validator.effective_balance = min(
            balance - balance % EFFECTIVE_BALANCE_INCREMENT, MAX_EFFECTIVE_BALANCE  # noqa: F821
        )
        if validator.effective_balance == MAX_EFFECTIVE_BALANCE:  # noqa: F821
            validator.activation_eligibility_epoch = GENESIS_EPOCH
            validator.activation_epoch = GENESIS_EPOCH

    state.genesis_validators_root = hash_tree_root(state.validators)
    return state


def is_valid_genesis_state(state: "BeaconState") -> bool:
    if state.genesis_time < config.MIN_GENESIS_TIME:  # noqa: F821
        return False
    if len(get_active_validator_indices(state, GENESIS_EPOCH)) < config.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT:  # noqa: F821
        return False
    return True


# ---------------------------------------------------------------------------
# State transition (beacon-chain.md:1241-1290)
# ---------------------------------------------------------------------------

def state_transition(state: "BeaconState", signed_block: SignedBeaconBlock, validate_result: bool = True) -> None:
    block = signed_block.message
    process_slots(state, block.slot)
    if validate_result:
        assert verify_block_signature(state, signed_block)
    process_block(state, block)
    if validate_result:
        assert block.state_root == hash_tree_root(state)


def verify_block_signature(state: "BeaconState", signed_block: SignedBeaconBlock) -> bool:
    proposer = state.validators[signed_block.message.proposer_index]
    signing_root = compute_signing_root(signed_block.message, get_domain(state, DOMAIN_BEACON_PROPOSER))
    return bls.Verify(proposer.pubkey, signing_root, signed_block.signature)


def process_slots(state: "BeaconState", slot: Slot) -> None:
    assert state.slot < slot
    while state.slot < slot:
        process_slot(state)
        # Epoch processing at the boundary slot
        if (state.slot + 1) % SLOTS_PER_EPOCH == 0:  # noqa: F821
            process_epoch(state)
        state.slot = Slot(state.slot + 1)


def process_slot(state: "BeaconState") -> None:
    # Cache state root, fill in header root hole, cache block root
    previous_state_root = hash_tree_root(state)
    state.state_roots[state.slot % SLOTS_PER_HISTORICAL_ROOT] = previous_state_root  # noqa: F821
    if state.latest_block_header.state_root == Bytes32():
        state.latest_block_header.state_root = previous_state_root
    previous_block_root = hash_tree_root(state.latest_block_header)
    state.block_roots[state.slot % SLOTS_PER_HISTORICAL_ROOT] = previous_block_root  # noqa: F821


# ---------------------------------------------------------------------------
# Epoch processing (beacon-chain.md:1289-1684)
# ---------------------------------------------------------------------------

def epoch_process_steps():
    """Canonical per-epoch sub-transition order (beacon-chain.md:1289).
    Resolved from module globals at call time so fork overrides of both
    the list and the individual steps late-bind; test staging walks it."""
    return [
        process_justification_and_finalization,
        process_rewards_and_penalties,
        process_registry_updates,
        process_slashings,
        process_eth1_data_reset,
        process_effective_balance_updates,
        process_slashings_reset,
        process_randao_mixes_reset,
        process_historical_roots_update,
        process_participation_record_updates,
    ]


def process_epoch(state: "BeaconState") -> None:
    for step in epoch_process_steps():
        step(state)


def get_matching_source_attestations(state: "BeaconState", epoch: Epoch) -> Sequence[PendingAttestation]:
    assert epoch in (get_previous_epoch(state), get_current_epoch(state))
    return state.current_epoch_attestations if epoch == get_current_epoch(state) else state.previous_epoch_attestations


def get_matching_target_attestations(state: "BeaconState", epoch: Epoch) -> Sequence[PendingAttestation]:
    return [
        a for a in get_matching_source_attestations(state, epoch)
        if a.data.target.root == get_block_root(state, epoch)
    ]


def get_matching_head_attestations(state: "BeaconState", epoch: Epoch) -> Sequence[PendingAttestation]:
    return [
        a for a in get_matching_target_attestations(state, epoch)
        if a.data.beacon_block_root == get_block_root_at_slot(state, a.data.slot)
    ]


def get_unslashed_attesting_indices(state: "BeaconState", attestations: Sequence[PendingAttestation]) -> Set[ValidatorIndex]:
    output: Set[ValidatorIndex] = set()
    for a in attestations:
        output = output.union(get_attesting_indices(state, a.data, a.aggregation_bits))
    return set(filter(lambda index: not state.validators[index].slashed, output))


def get_attesting_balance(state: "BeaconState", attestations: Sequence[PendingAttestation]) -> Gwei:
    return get_total_balance(state, get_unslashed_attesting_indices(state, attestations))


def process_justification_and_finalization(state: "BeaconState") -> None:
    # Skip FFG updates in first two epochs (no previous-epoch attestations yet)
    if get_current_epoch(state) <= GENESIS_EPOCH + 1:
        return
    previous_attestations = get_matching_target_attestations(state, get_previous_epoch(state))
    current_attestations = get_matching_target_attestations(state, get_current_epoch(state))
    total_active_balance = get_total_active_balance(state)
    previous_target_balance = get_attesting_balance(state, previous_attestations)
    current_target_balance = get_attesting_balance(state, current_attestations)
    weigh_justification_and_finalization(state, total_active_balance, previous_target_balance, current_target_balance)


def weigh_justification_and_finalization(state: "BeaconState", total_active_balance: Gwei,
                                         previous_epoch_target_balance: Gwei,
                                         current_epoch_target_balance: Gwei) -> None:
    previous_epoch = get_previous_epoch(state)
    current_epoch = get_current_epoch(state)
    old_previous_justified_checkpoint = state.previous_justified_checkpoint
    old_current_justified_checkpoint = state.current_justified_checkpoint

    # Justification
    state.previous_justified_checkpoint = state.current_justified_checkpoint
    state.justification_bits[1:] = state.justification_bits[: JUSTIFICATION_BITS_LENGTH - 1]
    state.justification_bits[0] = 0b0
    if previous_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=previous_epoch, root=get_block_root(state, previous_epoch)
        )
        state.justification_bits[1] = 0b1
    if current_epoch_target_balance * 3 >= total_active_balance * 2:
        state.current_justified_checkpoint = Checkpoint(
            epoch=current_epoch, root=get_block_root(state, current_epoch)
        )
        state.justification_bits[0] = 0b1

    # Finalization
    bits = state.justification_bits
    # 2nd/3rd/4th most recent justified, 2nd as source
    if all(bits[1:4]) and old_previous_justified_checkpoint.epoch + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified_checkpoint
    # 2nd/3rd most recent justified, 2nd as source
    if all(bits[1:3]) and old_previous_justified_checkpoint.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified_checkpoint
    # 1st/2nd/3rd most recent justified, 1st as source
    if all(bits[0:3]) and old_current_justified_checkpoint.epoch + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified_checkpoint
    # 1st/2nd most recent justified, 1st as source
    if all(bits[0:2]) and old_current_justified_checkpoint.epoch + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified_checkpoint


# -- rewards & penalties (beacon-chain.md:1404-1566) --

def get_base_reward(state: "BeaconState", index: ValidatorIndex) -> Gwei:
    return _base_reward(state, index, integer_squareroot(get_total_active_balance(state)))


def _base_reward(state: "BeaconState", index: ValidatorIndex, sqrt_total_balance: uint64) -> Gwei:
    effective_balance = state.validators[index].effective_balance
    return Gwei(effective_balance * BASE_REWARD_FACTOR // sqrt_total_balance // BASE_REWARDS_PER_EPOCH)  # noqa: F821


def get_proposer_reward(state: "BeaconState", attesting_index: ValidatorIndex) -> Gwei:
    return Gwei(get_base_reward(state, attesting_index) // PROPOSER_REWARD_QUOTIENT)  # noqa: F821


def get_finality_delay(state: "BeaconState") -> uint64:
    return get_previous_epoch(state) - state.finalized_checkpoint.epoch


def is_in_inactivity_leak(state: "BeaconState") -> bool:
    return get_finality_delay(state) > MIN_EPOCHS_TO_INACTIVITY_PENALTY  # noqa: F821


def get_eligible_validator_indices(state: "BeaconState") -> Sequence[ValidatorIndex]:
    previous_epoch = get_previous_epoch(state)
    return [
        ValidatorIndex(index) for index, v in enumerate(state.validators)
        if is_active_validator(v, previous_epoch) or (v.slashed and previous_epoch + 1 < v.withdrawable_epoch)
    ]


def get_attestation_component_deltas(state: "BeaconState", attestations: Sequence[PendingAttestation]) -> Tuple[Sequence[Gwei], Sequence[Gwei]]:
    """Shared source/target/head component logic (beacon-chain.md:1440).
    Total-balance and sqrt are hoisted out of the per-index loop; results
    are bit-identical to the reference."""
    rewards = [Gwei(0)] * len(state.validators)
    penalties = [Gwei(0)] * len(state.validators)
    total_balance = get_total_active_balance(state)
    sqrt_total = integer_squareroot(total_balance)
    unslashed_attesting_indices = get_unslashed_attesting_indices(state, attestations)
    attesting_balance = get_total_balance(state, unslashed_attesting_indices)
    leak = is_in_inactivity_leak(state)
    increment = EFFECTIVE_BALANCE_INCREMENT  # noqa: F821
    for index in get_eligible_validator_indices(state):
        base = _base_reward(state, index, sqrt_total)
        if index in unslashed_attesting_indices:
            if leak:
                # Full base reward: cancelled against inactivity penalties
                rewards[index] += base
            else:
                reward_numerator = base * (attesting_balance // increment)
                rewards[index] += reward_numerator // (total_balance // increment)
        else:
            penalties[index] += base
    return rewards, penalties


def get_source_deltas(state: "BeaconState") -> Tuple[Sequence[Gwei], Sequence[Gwei]]:
    return get_attestation_component_deltas(
        state, get_matching_source_attestations(state, get_previous_epoch(state))
    )


def get_target_deltas(state: "BeaconState") -> Tuple[Sequence[Gwei], Sequence[Gwei]]:
    return get_attestation_component_deltas(
        state, get_matching_target_attestations(state, get_previous_epoch(state))
    )


def get_head_deltas(state: "BeaconState") -> Tuple[Sequence[Gwei], Sequence[Gwei]]:
    return get_attestation_component_deltas(
        state, get_matching_head_attestations(state, get_previous_epoch(state))
    )


def get_inclusion_delay_deltas(state: "BeaconState") -> Tuple[Sequence[Gwei], Sequence[Gwei]]:
    """Proposer + inclusion-delay micro-rewards (beacon-chain.md:1496).
    Single stable-sorted sweep replaces the reference's per-index min() scan;
    the earliest-inclusion attestation per index is identical."""
    n = len(state.validators)
    rewards = [Gwei(0)] * n
    sqrt_total = integer_squareroot(get_total_active_balance(state))
    matching_source_attestations = get_matching_source_attestations(state, get_previous_epoch(state))
    unslashed = get_unslashed_attesting_indices(state, matching_source_attestations)
    best: Dict[int, PendingAttestation] = {}
    for attestation in sorted(matching_source_attestations, key=lambda a: int(a.inclusion_delay)):
        for index in get_attesting_indices(state, attestation.data, attestation.aggregation_bits):
            if index in unslashed and index not in best:
                best[index] = attestation
    for index, attestation in best.items():
        base = _base_reward(state, index, sqrt_total)
        proposer_reward = Gwei(base // PROPOSER_REWARD_QUOTIENT)  # noqa: F821
        rewards[attestation.proposer_index] += proposer_reward
        max_attester_reward = Gwei(base - proposer_reward)
        rewards[index] += Gwei(max_attester_reward // attestation.inclusion_delay)
    penalties = [Gwei(0)] * n
    return rewards, penalties


def get_inactivity_penalty_deltas(state: "BeaconState") -> Tuple[Sequence[Gwei], Sequence[Gwei]]:
    """Quadratic-leak penalties (beacon-chain.md:1521)."""
    n = len(state.validators)
    penalties = [Gwei(0)] * n
    if is_in_inactivity_leak(state):
        sqrt_total = integer_squareroot(get_total_active_balance(state))
        matching_target_attestations = get_matching_target_attestations(state, get_previous_epoch(state))
        matching_target_attesting_indices = get_unslashed_attesting_indices(state, matching_target_attestations)
        finality_delay = get_finality_delay(state)
        for index in get_eligible_validator_indices(state):
            base = _base_reward(state, index, sqrt_total)
            proposer_reward = Gwei(base // PROPOSER_REWARD_QUOTIENT)  # noqa: F821
            penalties[index] += Gwei(BASE_REWARDS_PER_EPOCH * base - proposer_reward)
            if index not in matching_target_attesting_indices:
                effective_balance = state.validators[index].effective_balance
                penalties[index] += Gwei(effective_balance * finality_delay // INACTIVITY_PENALTY_QUOTIENT)  # noqa: F821
    rewards = [Gwei(0)] * n
    return rewards, penalties


def get_attestation_deltas(state: "BeaconState") -> Tuple[Sequence[Gwei], Sequence[Gwei]]:
    source_rewards, source_penalties = get_source_deltas(state)
    target_rewards, target_penalties = get_target_deltas(state)
    head_rewards, head_penalties = get_head_deltas(state)
    inclusion_delay_rewards, _ = get_inclusion_delay_deltas(state)
    _, inactivity_penalties = get_inactivity_penalty_deltas(state)

    rewards = [
        source_rewards[i] + target_rewards[i] + head_rewards[i] + inclusion_delay_rewards[i]
        for i in range(len(state.validators))
    ]
    penalties = [
        source_penalties[i] + target_penalties[i] + head_penalties[i] + inactivity_penalties[i]
        for i in range(len(state.validators))
    ]
    return rewards, penalties


def process_rewards_and_penalties(state: "BeaconState") -> None:
    # Rewards are for work in the previous epoch; none at GENESIS_EPOCH
    if get_current_epoch(state) == GENESIS_EPOCH:
        return
    rewards, penalties = get_attestation_deltas(state)
    for index in range(len(state.validators)):
        increase_balance(state, ValidatorIndex(index), rewards[index])
        decrease_balance(state, ValidatorIndex(index), penalties[index])


def process_registry_updates(state: "BeaconState") -> None:
    # Activation eligibility and ejections
    for index, validator in enumerate(state.validators):
        if is_eligible_for_activation_queue(validator):
            validator.activation_eligibility_epoch = get_current_epoch(state) + 1
        if (
            is_active_validator(validator, get_current_epoch(state))
            and validator.effective_balance <= config.EJECTION_BALANCE  # noqa: F821
        ):
            initiate_validator_exit(state, ValidatorIndex(index))

    # Dequeue activations up to churn limit, ordered by (eligibility epoch, index)
    activation_queue = sorted(
        [
            index for index, validator in enumerate(state.validators)
            if is_eligible_for_activation(state, validator)
        ],
        key=lambda index: (state.validators[index].activation_eligibility_epoch, index),
    )
    for index in activation_queue[: get_validator_churn_limit(state)]:
        validator = state.validators[index]
        validator.activation_epoch = compute_activation_exit_epoch(get_current_epoch(state))


def process_slashings(state: "BeaconState") -> None:
    epoch = get_current_epoch(state)
    total_balance = get_total_active_balance(state)
    adjusted_total_slashing_balance = min(
        sum(int(s) for s in state.slashings) * PROPORTIONAL_SLASHING_MULTIPLIER,  # noqa: F821
        total_balance,
    )
    increment = EFFECTIVE_BALANCE_INCREMENT  # noqa: F821
    for index, validator in enumerate(state.validators):
        if validator.slashed and epoch + EPOCHS_PER_SLASHINGS_VECTOR // 2 == validator.withdrawable_epoch:  # noqa: F821
            penalty_numerator = validator.effective_balance // increment * adjusted_total_slashing_balance
            penalty = penalty_numerator // total_balance * increment
            decrease_balance(state, ValidatorIndex(index), Gwei(penalty))


def process_eth1_data_reset(state: "BeaconState") -> None:
    next_epoch = Epoch(get_current_epoch(state) + 1)
    if next_epoch % EPOCHS_PER_ETH1_VOTING_PERIOD == 0:  # noqa: F821
        state.eth1_data_votes = []


def process_effective_balance_updates(state: "BeaconState") -> None:
    hysteresis_increment = uint64(EFFECTIVE_BALANCE_INCREMENT // HYSTERESIS_QUOTIENT)  # noqa: F821
    downward_threshold = hysteresis_increment * HYSTERESIS_DOWNWARD_MULTIPLIER  # noqa: F821
    upward_threshold = hysteresis_increment * HYSTERESIS_UPWARD_MULTIPLIER  # noqa: F821
    for index, validator in enumerate(state.validators):
        balance = state.balances[index]
        if (
            balance + downward_threshold < validator.effective_balance
            or validator.effective_balance + upward_threshold < balance
        ):
            validator.effective_balance = min(
                balance - balance % EFFECTIVE_BALANCE_INCREMENT, MAX_EFFECTIVE_BALANCE  # noqa: F821
            )


def process_slashings_reset(state: "BeaconState") -> None:
    next_epoch = Epoch(get_current_epoch(state) + 1)
    state.slashings[next_epoch % EPOCHS_PER_SLASHINGS_VECTOR] = Gwei(0)  # noqa: F821


def process_randao_mixes_reset(state: "BeaconState") -> None:
    current_epoch = get_current_epoch(state)
    next_epoch = Epoch(current_epoch + 1)
    state.randao_mixes[next_epoch % EPOCHS_PER_HISTORICAL_VECTOR] = get_randao_mix(state, current_epoch)  # noqa: F821


def process_historical_roots_update(state: "BeaconState") -> None:
    next_epoch = Epoch(get_current_epoch(state) + 1)
    if next_epoch % (SLOTS_PER_HISTORICAL_ROOT // SLOTS_PER_EPOCH) == 0:  # noqa: F821
        historical_batch = HistoricalBatch(block_roots=state.block_roots, state_roots=state.state_roots)
        state.historical_roots.append(hash_tree_root(historical_batch))


def process_participation_record_updates(state: "BeaconState") -> None:
    state.previous_epoch_attestations = state.current_epoch_attestations
    state.current_epoch_attestations = []


# ---------------------------------------------------------------------------
# Block processing (beacon-chain.md:1686-1913)
# ---------------------------------------------------------------------------

def process_block(state: "BeaconState", block: BeaconBlock) -> None:
    process_block_header(state, block)
    process_randao(state, block.body)
    process_eth1_data(state, block.body)
    process_operations(state, block.body)


def block_process_steps():
    """Ordered (name, apply) sub-transition table for this fork's
    process_block — test infrastructure uses it to stage a state up to a
    given sub-transition. Later forks override with their own order."""
    return [
        ("process_block_header", lambda state, block: process_block_header(state, block)),
        ("process_randao", lambda state, block: process_randao(state, block.body)),
        ("process_eth1_data", lambda state, block: process_eth1_data(state, block.body)),
        ("process_operations", lambda state, block: process_operations(state, block.body)),
    ]


def process_block_header(state: "BeaconState", block: BeaconBlock) -> None:
    # Slot/proposer/parent consistency
    assert block.slot == state.slot
    assert block.slot > state.latest_block_header.slot
    assert block.proposer_index == get_beacon_proposer_index(state)
    assert block.parent_root == hash_tree_root(state.latest_block_header)
    state.latest_block_header = BeaconBlockHeader(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=block.parent_root,
        state_root=Bytes32(),  # overwritten at next process_slot
        body_root=hash_tree_root(block.body),
    )
    proposer = state.validators[block.proposer_index]
    assert not proposer.slashed


def process_randao(state: "BeaconState", body: BeaconBlockBody) -> None:
    epoch = get_current_epoch(state)
    proposer = state.validators[get_beacon_proposer_index(state)]
    signing_root = compute_signing_root(uint64(epoch), get_domain(state, DOMAIN_RANDAO))
    assert bls.Verify(proposer.pubkey, signing_root, body.randao_reveal)
    mix = xor(get_randao_mix(state, epoch), hash(body.randao_reveal))
    state.randao_mixes[epoch % EPOCHS_PER_HISTORICAL_VECTOR] = mix  # noqa: F821


def process_eth1_data(state: "BeaconState", body: BeaconBlockBody) -> None:
    state.eth1_data_votes.append(body.eth1_data)
    if state.eth1_data_votes.count(body.eth1_data) * 2 > EPOCHS_PER_ETH1_VOTING_PERIOD * SLOTS_PER_EPOCH:  # noqa: F821
        state.eth1_data = body.eth1_data


def process_operations(state: "BeaconState", body: BeaconBlockBody) -> None:
    # Deposits must drain the queue up to MAX_DEPOSITS
    assert len(body.deposits) == min(
        MAX_DEPOSITS, state.eth1_data.deposit_count - state.eth1_deposit_index  # noqa: F821
    )

    def for_ops(operations, fn: Callable) -> None:
        for operation in operations:
            fn(state, operation)

    for_ops(body.proposer_slashings, process_proposer_slashing)
    for_ops(body.attester_slashings, process_attester_slashing)
    for_ops(body.attestations, process_attestation)
    for_ops(body.deposits, process_deposit)
    for_ops(body.voluntary_exits, process_voluntary_exit)


def process_proposer_slashing(state: "BeaconState", proposer_slashing: ProposerSlashing) -> None:
    header_1 = proposer_slashing.signed_header_1.message
    header_2 = proposer_slashing.signed_header_2.message
    assert header_1.slot == header_2.slot
    assert header_1.proposer_index == header_2.proposer_index
    assert header_1 != header_2
    proposer = state.validators[header_1.proposer_index]
    assert is_slashable_validator(proposer, get_current_epoch(state))
    for signed_header in (proposer_slashing.signed_header_1, proposer_slashing.signed_header_2):
        domain = get_domain(state, DOMAIN_BEACON_PROPOSER, compute_epoch_at_slot(signed_header.message.slot))
        signing_root = compute_signing_root(signed_header.message, domain)
        assert bls.Verify(proposer.pubkey, signing_root, signed_header.signature)
    slash_validator(state, header_1.proposer_index)


def process_attester_slashing(state: "BeaconState", attester_slashing: AttesterSlashing) -> None:
    attestation_1 = attester_slashing.attestation_1
    attestation_2 = attester_slashing.attestation_2
    assert is_slashable_attestation_data(attestation_1.data, attestation_2.data)
    assert is_valid_indexed_attestation(state, attestation_1)
    assert is_valid_indexed_attestation(state, attestation_2)

    slashed_any = False
    indices = set(attestation_1.attesting_indices).intersection(attestation_2.attesting_indices)
    for index in sorted(indices):
        if is_slashable_validator(state.validators[index], get_current_epoch(state)):
            slash_validator(state, index)
            slashed_any = True
    assert slashed_any


def process_attestation(state: "BeaconState", attestation: Attestation) -> None:
    data = attestation.data
    assert data.target.epoch in (get_previous_epoch(state), get_current_epoch(state))
    assert data.target.epoch == compute_epoch_at_slot(data.slot)
    assert data.slot + MIN_ATTESTATION_INCLUSION_DELAY <= state.slot <= data.slot + SLOTS_PER_EPOCH  # noqa: F821
    assert data.index < get_committee_count_per_slot(state, data.target.epoch)

    committee = get_beacon_committee(state, data.slot, data.index)
    assert len(attestation.aggregation_bits) == len(committee)

    pending_attestation = PendingAttestation(
        data=data,
        aggregation_bits=attestation.aggregation_bits,
        inclusion_delay=state.slot - data.slot,
        proposer_index=get_beacon_proposer_index(state),
    )
    if data.target.epoch == get_current_epoch(state):
        assert data.source == state.current_justified_checkpoint
        state.current_epoch_attestations.append(pending_attestation)
    else:
        assert data.source == state.previous_justified_checkpoint
        state.previous_epoch_attestations.append(pending_attestation)

    # Signature last (cheapest rejections first)
    assert is_valid_indexed_attestation(state, get_indexed_attestation(state, attestation))


def get_validator_from_deposit(deposit: Deposit) -> Validator:
    amount = deposit.data.amount
    effective_balance = min(amount - amount % EFFECTIVE_BALANCE_INCREMENT, MAX_EFFECTIVE_BALANCE)  # noqa: F821
    return Validator(
        pubkey=deposit.data.pubkey,
        withdrawal_credentials=deposit.data.withdrawal_credentials,
        activation_eligibility_epoch=FAR_FUTURE_EPOCH,
        activation_epoch=FAR_FUTURE_EPOCH,
        exit_epoch=FAR_FUTURE_EPOCH,
        withdrawable_epoch=FAR_FUTURE_EPOCH,
        effective_balance=effective_balance,
    )


def process_deposit(state: "BeaconState", deposit: Deposit) -> None:
    # Merkle proof against the eth1 deposit root
    assert is_valid_merkle_branch(
        leaf=hash_tree_root(deposit.data),
        branch=deposit.proof,
        depth=DEPOSIT_CONTRACT_TREE_DEPTH + 1,  # +1 for the length mix-in
        index=state.eth1_deposit_index,
        root=state.eth1_data.deposit_root,
    )
    state.eth1_deposit_index += 1

    pubkey = deposit.data.pubkey
    amount = deposit.data.amount
    validator_pubkeys = [v.pubkey for v in state.validators]
    if pubkey not in validator_pubkeys:
        # New validator: verify proof-of-possession with the fork-agnostic
        # deposit domain; invalid signatures skip (don't fail) the deposit
        deposit_message = DepositMessage(
            pubkey=deposit.data.pubkey,
            withdrawal_credentials=deposit.data.withdrawal_credentials,
            amount=deposit.data.amount,
        )
        domain = compute_domain(DOMAIN_DEPOSIT)
        signing_root = compute_signing_root(deposit_message, domain)
        if not bls.Verify(pubkey, signing_root, deposit.data.signature):
            return
        state.validators.append(get_validator_from_deposit(deposit))
        state.balances.append(amount)
    else:
        index = ValidatorIndex(validator_pubkeys.index(pubkey))
        increase_balance(state, index, amount)


def process_voluntary_exit(state: "BeaconState", signed_voluntary_exit: SignedVoluntaryExit) -> None:
    voluntary_exit = signed_voluntary_exit.message
    validator = state.validators[voluntary_exit.validator_index]
    assert is_active_validator(validator, get_current_epoch(state))
    assert validator.exit_epoch == FAR_FUTURE_EPOCH
    assert get_current_epoch(state) >= voluntary_exit.epoch
    assert get_current_epoch(state) >= validator.activation_epoch + config.SHARD_COMMITTEE_PERIOD  # noqa: F821
    domain = get_domain(state, DOMAIN_VOLUNTARY_EXIT, voluntary_exit.epoch)
    signing_root = compute_signing_root(voluntary_exit, domain)
    assert bls.Verify(validator.pubkey, signing_root, signed_voluntary_exit.signature)
    initiate_validator_exit(state, voluntary_exit.validator_index)


# ---------------------------------------------------------------------------
# Fork choice (fork-choice.md:85-487)
# ---------------------------------------------------------------------------

@dataclass(eq=True, frozen=True)
class LatestMessage:
    epoch: Epoch
    root: Root


@dataclass
class Store:
    time: uint64
    genesis_time: uint64
    justified_checkpoint: Checkpoint
    finalized_checkpoint: Checkpoint
    best_justified_checkpoint: Checkpoint
    proposer_boost_root: Root
    equivocating_indices: Set[ValidatorIndex]
    blocks: Dict[Root, BeaconBlock] = field(default_factory=dict)
    block_states: Dict[Root, "BeaconState"] = field(default_factory=dict)
    checkpoint_states: Dict[Checkpoint, "BeaconState"] = field(default_factory=dict)
    latest_messages: Dict[ValidatorIndex, LatestMessage] = field(default_factory=dict)


def get_forkchoice_store(anchor_state: "BeaconState", anchor_block: BeaconBlock) -> Store:
    assert anchor_block.state_root == hash_tree_root(anchor_state)
    anchor_root = Root(hash_tree_root(anchor_block))
    anchor_epoch = get_current_epoch(anchor_state)
    justified_checkpoint = Checkpoint(epoch=anchor_epoch, root=anchor_root)
    finalized_checkpoint = Checkpoint(epoch=anchor_epoch, root=anchor_root)
    return Store(
        time=uint64(anchor_state.genesis_time + config.SECONDS_PER_SLOT * anchor_state.slot),  # noqa: F821
        genesis_time=anchor_state.genesis_time,
        justified_checkpoint=justified_checkpoint,
        finalized_checkpoint=finalized_checkpoint,
        best_justified_checkpoint=justified_checkpoint,
        proposer_boost_root=Root(),
        equivocating_indices=set(),
        blocks={anchor_root: copy(anchor_block)},
        block_states={anchor_root: copy(anchor_state)},
        checkpoint_states={justified_checkpoint: copy(anchor_state)},
    )


def get_slots_since_genesis(store: Store) -> int:
    return (store.time - store.genesis_time) // config.SECONDS_PER_SLOT  # noqa: F821


def get_current_slot(store: Store) -> Slot:
    return Slot(GENESIS_SLOT + get_slots_since_genesis(store))


def compute_slots_since_epoch_start(slot: Slot) -> int:
    return slot - compute_start_slot_at_epoch(compute_epoch_at_slot(slot))


def get_ancestor(store: Store, root: Root, slot: Slot) -> Root:
    block = store.blocks[root]
    if block.slot > slot:
        return get_ancestor(store, block.parent_root, slot)
    # At or before the queried slot (skip slots return the most recent root)
    return root


def get_latest_attesting_balance(store: Store, root: Root) -> Gwei:
    """LMD-GHOST weight incl. proposer boost (fork-choice.md:179)."""
    state = store.checkpoint_states[store.justified_checkpoint]
    active_indices = get_active_validator_indices(state, get_current_epoch(state))
    attestation_score = Gwei(sum(
        int(state.validators[i].effective_balance) for i in active_indices
        if (
            i in store.latest_messages
            and i not in store.equivocating_indices
            and get_ancestor(store, store.latest_messages[i].root, store.blocks[root].slot) == root
        )
    ))
    if store.proposer_boost_root == Root():
        return attestation_score

    proposer_score = Gwei(0)
    if get_ancestor(store, store.proposer_boost_root, store.blocks[root].slot) == root:
        num_validators = len(active_indices)
        avg_balance = get_total_active_balance(state) // num_validators
        committee_size = num_validators // SLOTS_PER_EPOCH  # noqa: F821
        committee_weight = committee_size * avg_balance
        proposer_score = Gwei((committee_weight * config.PROPOSER_SCORE_BOOST) // 100)  # noqa: F821
    return Gwei(attestation_score + proposer_score)


def filter_block_tree(store: Store, block_root: Root, blocks: Dict[Root, BeaconBlock]) -> bool:
    """Viability filter: keep branches whose leaves agree with the store's
    justified/finalized checkpoints (fork-choice.md:208)."""
    block = store.blocks[block_root]
    children = [root for root in store.blocks.keys() if store.blocks[root].parent_root == block_root]

    if any(children):
        filter_results = [filter_block_tree(store, child, blocks) for child in children]
        if any(filter_results):
            blocks[block_root] = block
            return True
        return False

    head_state = store.block_states[block_root]
    correct_justified = (
        store.justified_checkpoint.epoch == GENESIS_EPOCH
        or head_state.current_justified_checkpoint == store.justified_checkpoint
    )
    correct_finalized = (
        store.finalized_checkpoint.epoch == GENESIS_EPOCH
        or head_state.finalized_checkpoint == store.finalized_checkpoint
    )
    if correct_justified and correct_finalized:
        blocks[block_root] = block
        return True
    return False


def get_filtered_block_tree(store: Store) -> Dict[Root, BeaconBlock]:
    base = store.justified_checkpoint.root
    blocks: Dict[Root, BeaconBlock] = {}
    filter_block_tree(store, base, blocks)
    return blocks


def get_head(store: Store) -> Root:
    """LMD-GHOST argmax walk, ties broken by higher root (fork-choice.md:261)."""
    blocks = get_filtered_block_tree(store)
    head = store.justified_checkpoint.root
    while True:
        children = [root for root in blocks.keys() if blocks[root].parent_root == head]
        if len(children) == 0:
            return head
        head = max(children, key=lambda root: (get_latest_attesting_balance(store, root), bytes(root)))


def should_update_justified_checkpoint(store: Store, new_justified_checkpoint: Checkpoint) -> bool:
    """Bouncing-attack guard (fork-choice.md:285)."""
    if compute_slots_since_epoch_start(get_current_slot(store)) < SAFE_SLOTS_TO_UPDATE_JUSTIFIED:  # noqa: F821
        return True
    justified_slot = compute_start_slot_at_epoch(store.justified_checkpoint.epoch)
    if not get_ancestor(store, new_justified_checkpoint.root, justified_slot) == store.justified_checkpoint.root:
        return False
    return True


def validate_target_epoch_against_current_time(store: Store, attestation: Attestation) -> None:
    target = attestation.data.target
    current_epoch = compute_epoch_at_slot(get_current_slot(store))
    previous_epoch = current_epoch - 1 if current_epoch > GENESIS_EPOCH else GENESIS_EPOCH
    assert target.epoch in [current_epoch, previous_epoch]


def validate_on_attestation(store: Store, attestation: Attestation, is_from_block: bool) -> None:
    target = attestation.data.target

    if not is_from_block:
        validate_target_epoch_against_current_time(store, attestation)

    assert target.epoch == compute_epoch_at_slot(attestation.data.slot)
    # Target and LMD-vote blocks must be known (else delay consideration)
    assert target.root in store.blocks
    assert attestation.data.beacon_block_root in store.blocks
    # No attesting to future blocks
    assert store.blocks[attestation.data.beacon_block_root].slot <= attestation.data.slot
    # LMD vote consistent with FFG target
    target_slot = compute_start_slot_at_epoch(target.epoch)
    assert target.root == get_ancestor(store, attestation.data.beacon_block_root, target_slot)
    # Only affects subsequent slots
    assert get_current_slot(store) >= attestation.data.slot + 1


def store_target_checkpoint_state(store: Store, target: Checkpoint) -> None:
    if target not in store.checkpoint_states:
        base_state = copy(store.block_states[target.root])
        if base_state.slot < compute_start_slot_at_epoch(target.epoch):
            process_slots(base_state, compute_start_slot_at_epoch(target.epoch))
        store.checkpoint_states[target] = base_state


def update_latest_messages(store: Store, attesting_indices: Sequence[ValidatorIndex], attestation: Attestation) -> None:
    target = attestation.data.target
    beacon_block_root = attestation.data.beacon_block_root
    non_equivocating = [i for i in attesting_indices if i not in store.equivocating_indices]
    for i in non_equivocating:
        if i not in store.latest_messages or target.epoch > store.latest_messages[i].epoch:
            store.latest_messages[i] = LatestMessage(epoch=target.epoch, root=beacon_block_root)


def on_tick(store: Store, time: uint64) -> None:
    previous_slot = get_current_slot(store)
    store.time = time
    current_slot = get_current_slot(store)

    if current_slot > previous_slot:
        store.proposer_boost_root = Root()

    # Remaining work only at epoch rollover
    if not (current_slot > previous_slot and compute_slots_since_epoch_start(current_slot) == 0):
        return

    # Pull up justified checkpoint if best is on the finalized chain
    if store.best_justified_checkpoint.epoch > store.justified_checkpoint.epoch:
        finalized_slot = compute_start_slot_at_epoch(store.finalized_checkpoint.epoch)
        ancestor_at_finalized_slot = get_ancestor(store, store.best_justified_checkpoint.root, finalized_slot)
        if ancestor_at_finalized_slot == store.finalized_checkpoint.root:
            store.justified_checkpoint = store.best_justified_checkpoint


def on_block(store: Store, signed_block: SignedBeaconBlock) -> None:
    block = signed_block.message
    assert block.parent_root in store.block_states
    pre_state = copy(store.block_states[block.parent_root])
    # No future blocks
    assert get_current_slot(store) >= block.slot
    # Must descend from (and be after) the finalized checkpoint
    finalized_slot = compute_start_slot_at_epoch(store.finalized_checkpoint.epoch)
    assert block.slot > finalized_slot
    assert get_ancestor(store, block.parent_root, finalized_slot) == store.finalized_checkpoint.root

    state = pre_state.copy()
    state_transition(state, signed_block, True)
    block_root = Root(hash_tree_root(block))
    store.blocks[block_root] = block
    store.block_states[block_root] = state

    # Proposer boost for timely blocks
    time_into_slot = (store.time - store.genesis_time) % config.SECONDS_PER_SLOT  # noqa: F821
    is_before_attesting_interval = time_into_slot < config.SECONDS_PER_SLOT // INTERVALS_PER_SLOT  # noqa: F821
    if get_current_slot(store) == block.slot and is_before_attesting_interval:
        store.proposer_boost_root = block_root

    # Justified checkpoint updates
    if state.current_justified_checkpoint.epoch > store.justified_checkpoint.epoch:
        if state.current_justified_checkpoint.epoch > store.best_justified_checkpoint.epoch:
            store.best_justified_checkpoint = state.current_justified_checkpoint
        if should_update_justified_checkpoint(store, state.current_justified_checkpoint):
            store.justified_checkpoint = state.current_justified_checkpoint

    # Finalized checkpoint updates
    if state.finalized_checkpoint.epoch > store.finalized_checkpoint.epoch:
        store.finalized_checkpoint = state.finalized_checkpoint
        store.justified_checkpoint = state.current_justified_checkpoint


def on_attestation(store: Store, attestation: Attestation, is_from_block: bool = False) -> None:
    validate_on_attestation(store, attestation, is_from_block)
    store_target_checkpoint_state(store, attestation.data.target)

    target_state = store.checkpoint_states[attestation.data.target]
    indexed_attestation = get_indexed_attestation(target_state, attestation)
    assert is_valid_indexed_attestation(target_state, indexed_attestation)

    update_latest_messages(store, indexed_attestation.attesting_indices, attestation)


def on_attester_slashing(store: Store, attester_slashing: AttesterSlashing) -> None:
    attestation_1 = attester_slashing.attestation_1
    attestation_2 = attester_slashing.attestation_2
    assert is_slashable_attestation_data(attestation_1.data, attestation_2.data)
    state = store.block_states[store.justified_checkpoint.root]
    assert is_valid_indexed_attestation(state, attestation_1)
    assert is_valid_indexed_attestation(state, attestation_2)

    indices = set(attestation_1.attesting_indices).intersection(attestation_2.attesting_indices)
    for index in indices:
        store.equivocating_indices.add(index)


# ---------------------------------------------------------------------------
# Honest validator guide (validator.md)
# ---------------------------------------------------------------------------

def check_if_validator_active(state: "BeaconState", validator_index: ValidatorIndex) -> bool:
    return is_active_validator(state.validators[validator_index], get_current_epoch(state))


def get_committee_assignment(state: "BeaconState", epoch: Epoch, validator_index: ValidatorIndex) -> Optional[Tuple[Sequence[ValidatorIndex], CommitteeIndex, Slot]]:
    """(committee, index, slot) for the validator's attestation duty, or None
    (validator.md:215)."""
    next_epoch = Epoch(get_current_epoch(state) + 1)
    assert epoch <= next_epoch

    start_slot = compute_start_slot_at_epoch(epoch)
    committee_count_per_slot = get_committee_count_per_slot(state, epoch)
    for slot in range(start_slot, start_slot + SLOTS_PER_EPOCH):  # noqa: F821
        for index in range(committee_count_per_slot):
            committee = get_beacon_committee(state, Slot(slot), CommitteeIndex(index))
            if validator_index in committee:
                return committee, CommitteeIndex(index), Slot(slot)
    return None


def is_proposer(state: "BeaconState", validator_index: ValidatorIndex) -> bool:
    return get_beacon_proposer_index(state) == validator_index


def get_epoch_signature(state: "BeaconState", block: BeaconBlock, privkey: int) -> BLSSignature:
    domain = get_domain(state, DOMAIN_RANDAO, compute_epoch_at_slot(block.slot))
    signing_root = compute_signing_root(uint64(compute_epoch_at_slot(block.slot)), domain)
    return bls.Sign(privkey, signing_root)


def compute_time_at_slot(state: "BeaconState", slot: Slot) -> uint64:
    return uint64(state.genesis_time + slot * config.SECONDS_PER_SLOT)  # noqa: F821


def voting_period_start_time(state: "BeaconState") -> uint64:
    eth1_voting_period_start_slot = Slot(
        state.slot - state.slot % (EPOCHS_PER_ETH1_VOTING_PERIOD * SLOTS_PER_EPOCH)  # noqa: F821
    )
    return compute_time_at_slot(state, eth1_voting_period_start_slot)


def is_candidate_block(block: Eth1Block, period_start: uint64) -> bool:
    follow = config.SECONDS_PER_ETH1_BLOCK * config.ETH1_FOLLOW_DISTANCE  # noqa: F821
    return (
        block.timestamp + follow <= period_start
        and block.timestamp + follow * 2 >= period_start
    )


def get_eth1_data(block: Eth1Block) -> Eth1Data:
    """Test-infra stub mocking the eth1 chain view (setup.py:360-367);
    tests may monkeypatch this."""
    return Eth1Data(
        deposit_root=block.deposit_root,
        deposit_count=block.deposit_count,
        block_hash=hash_tree_root(block),
    )


def get_eth1_vote(state: "BeaconState", eth1_chain: Sequence[Eth1Block]) -> Eth1Data:
    """Majority vote over candidate eth1 blocks (validator.md:366)."""
    period_start = voting_period_start_time(state)
    votes_to_consider = [
        get_eth1_data(block) for block in eth1_chain
        if (
            is_candidate_block(block, period_start)
            and get_eth1_data(block).deposit_count >= state.eth1_data.deposit_count
        )
    ]
    valid_votes = [vote for vote in state.eth1_data_votes if vote in votes_to_consider]
    state_eth1_data: Eth1Data = state.eth1_data
    default_vote = votes_to_consider[-1] if any(votes_to_consider) else state_eth1_data
    return max(
        valid_votes,
        key=lambda v: (valid_votes.count(v), -valid_votes.index(v)),
        default=default_vote,
    )


def compute_new_state_root(state: "BeaconState", block: BeaconBlock) -> Root:
    """Dry-run transition to fill block.state_root (validator.md:430)."""
    temp_state: BeaconState = state.copy()
    signed_block = SignedBeaconBlock(message=block)
    state_transition(temp_state, signed_block, validate_result=False)
    return Root(hash_tree_root(temp_state))


def get_block_signature(state: "BeaconState", block: BeaconBlock, privkey: int) -> BLSSignature:
    domain = get_domain(state, DOMAIN_BEACON_PROPOSER, compute_epoch_at_slot(block.slot))
    signing_root = compute_signing_root(block, domain)
    return bls.Sign(privkey, signing_root)


def get_attestation_signature(state: "BeaconState", attestation_data: AttestationData, privkey: int) -> BLSSignature:
    domain = get_domain(state, DOMAIN_BEACON_ATTESTER, attestation_data.target.epoch)
    signing_root = compute_signing_root(attestation_data, domain)
    return bls.Sign(privkey, signing_root)


def compute_subnet_for_attestation(committees_per_slot: uint64, slot: Slot, committee_index: CommitteeIndex) -> uint64:
    """Gossip subnet for an attestation (validator.md:516)."""
    slots_since_epoch_start = uint64(slot % SLOTS_PER_EPOCH)  # noqa: F821
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start
    return uint64((committees_since_epoch_start + committee_index) % ATTESTATION_SUBNET_COUNT)


def get_slot_signature(state: "BeaconState", slot: Slot, privkey: int) -> BLSSignature:
    domain = get_domain(state, DOMAIN_SELECTION_PROOF, compute_epoch_at_slot(slot))
    signing_root = compute_signing_root(uint64(slot), domain)
    return bls.Sign(privkey, signing_root)


def is_aggregator(state: "BeaconState", slot: Slot, index: CommitteeIndex, slot_signature: BLSSignature) -> bool:
    committee = get_beacon_committee(state, slot, index)
    modulo = max(1, len(committee) // TARGET_AGGREGATORS_PER_COMMITTEE)
    return bytes_to_uint64(hash(slot_signature)[0:8]) % modulo == 0


def get_aggregate_signature(attestations: Sequence[Attestation]) -> BLSSignature:
    signatures = [attestation.signature for attestation in attestations]
    return bls.Aggregate(signatures)


def get_aggregate_and_proof(state: "BeaconState", aggregator_index: ValidatorIndex, aggregate: Attestation, privkey: int) -> AggregateAndProof:
    return AggregateAndProof(
        aggregator_index=aggregator_index,
        aggregate=aggregate,
        selection_proof=get_slot_signature(state, aggregate.data.slot, privkey),
    )


def get_aggregate_and_proof_signature(state: "BeaconState", aggregate_and_proof: AggregateAndProof, privkey: int) -> BLSSignature:
    aggregate = aggregate_and_proof.aggregate
    domain = get_domain(state, DOMAIN_AGGREGATE_AND_PROOF, compute_epoch_at_slot(aggregate.data.slot))
    signing_root = compute_signing_root(aggregate_and_proof, domain)
    return bls.Sign(privkey, signing_root)


# ---------------------------------------------------------------------------
# Weak subjectivity (weak-subjectivity.md:87-171)
# ---------------------------------------------------------------------------

def compute_weak_subjectivity_period(state: "BeaconState") -> uint64:
    """Epochs a ws checkpoint stays safe; see weak-subjectivity.md:75-120
    for the derivation of the two regimes."""
    ws_period = uint64(config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY)  # noqa: F821
    n = len(get_active_validator_indices(state, get_current_epoch(state)))
    t = get_total_active_balance(state) // n // ETH_TO_GWEI
    big_t = MAX_EFFECTIVE_BALANCE // ETH_TO_GWEI  # noqa: F821
    delta = get_validator_churn_limit(state)
    big_delta = MAX_DEPOSITS * SLOTS_PER_EPOCH  # noqa: F821
    d = SAFETY_DECAY

    if big_t * (200 + 3 * d) < t * (200 + 12 * d):
        epochs_for_validator_set_churn = (
            n * (t * (200 + 12 * d) - big_t * (200 + 3 * d)) // (600 * delta * (2 * t + big_t))
        )
        epochs_for_balance_top_ups = n * (200 + 3 * d) // (600 * big_delta)
        ws_period += uint64(max(epochs_for_validator_set_churn, epochs_for_balance_top_ups))
    else:
        ws_period += uint64(3 * n * d * t // (200 * big_delta * (big_t - t)))
    return ws_period


def is_within_weak_subjectivity_period(store: Store, ws_state: "BeaconState", ws_checkpoint: Checkpoint) -> bool:
    assert ws_state.latest_block_header.state_root == ws_checkpoint.root
    assert compute_epoch_at_slot(ws_state.slot) == ws_checkpoint.epoch

    ws_period = compute_weak_subjectivity_period(ws_state)
    ws_state_epoch = compute_epoch_at_slot(ws_state.slot)
    current_epoch = compute_epoch_at_slot(get_current_slot(store))
    return current_epoch <= ws_state_epoch + ws_period
