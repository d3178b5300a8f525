"""Sharding (R&D) spec source — delta over bellatrix
(ref: specs/sharding/beacon-chain.md at v1.1.10).

Shard blobs are KZG10-committed data columns: builders commit, proposers
co-sign headers on-chain, committees vote them confirmed, and an
EIP-1559-style sample-price market meters the data. The degree-proof
pairing check (beacon-chain.md:706-719) runs against the in-tree
development setup (crypto/kzg.py — the reference leaves G1_SETUP/G2_SETUP
undefined, beacon-chain.md:170-173); batched pairing verification rides
the device BLS backend and polynomial work the device FFT
(ops/{bls_torch,fft_torch}.py).

Preset naming: the reference's preset YAML says MAX_SAMPLES_PER_BLOCK /
TARGET_SAMPLES_PER_BLOCK while its spec text says *_PER_BLOB
(presets/mainnet/sharding.yaml:23-26 vs beacon-chain.md:163-166); the
YAML names are the loadable surface, aliased here to the spec names.
"""

# ---------------------------------------------------------------------------
# Custom types (sharding/beacon-chain.md:85-95)
# ---------------------------------------------------------------------------

class Shard(uint64):  # noqa: F821
    pass


class BuilderIndex(uint64):  # noqa: F821
    pass


class BLSCommitment(Bytes48):  # noqa: F821
    pass


class BLSPoint(uint256):  # noqa: F821
    pass


# ---------------------------------------------------------------------------
# Constants (sharding/beacon-chain.md:97-160)
# ---------------------------------------------------------------------------

PRIMITIVE_ROOT_OF_UNITY = 7
DATA_AVAILABILITY_INVERSE_CODING_RATE = 2**1
POINTS_PER_SAMPLE = uint64(2**3)  # noqa: F821
MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

DOMAIN_SHARD_BLOB = Bytes4(bytes.fromhex("80000000"))  # noqa: F821
DOMAIN_SHARD_PROPOSER = Bytes4(bytes.fromhex("81000000"))  # noqa: F821

SHARD_WORK_UNCONFIRMED = 0
SHARD_WORK_CONFIRMED = 1
SHARD_WORK_PENDING = 2

# Participation (sharding/beacon-chain.md:128-146): a fourth flag for
# timely shard-data votes
TIMELY_SHARD_FLAG_INDEX = 3
TIMELY_SHARD_WEIGHT = uint64(8)  # noqa: F821
PARTICIPATION_FLAG_WEIGHTS = [
    TIMELY_SOURCE_WEIGHT,  # noqa: F821
    TIMELY_TARGET_WEIGHT,  # noqa: F821
    TIMELY_HEAD_WEIGHT,  # noqa: F821
    TIMELY_SHARD_WEIGHT,
]

# spec-name aliases for the YAML preset vars (see module docstring)
MAX_SAMPLES_PER_BLOB = MAX_SAMPLES_PER_BLOCK  # noqa: F821
TARGET_SAMPLES_PER_BLOB = TARGET_SAMPLES_PER_BLOCK  # noqa: F821


# ---------------------------------------------------------------------------
# Trusted setup (sharding/beacon-chain.md:168-173 — upstream "TBD")
# ---------------------------------------------------------------------------

class _LazySetupSide:
    """List-like view of one side of the development setup, built on
    first use (KZG_SETUP_SIZE powers; INSECURE, test/dev only)."""

    def __init__(self, side: str, size: int):
        self._side = side
        self._size = int(size)
        self._points = None

    def _resolve(self):
        if self._points is None:
            from consensus_specs_tpu_torch.crypto.bls.curve import g1_to_bytes, g2_to_bytes
            from consensus_specs_tpu_torch.crypto.kzg import insecure_setup

            setup = insecure_setup(self._size)
            if self._side == "g1":
                self._points = [g1_to_bytes(p) for p in setup.g1_powers]
            else:
                self._points = setup.g2_powers  # Points (pairing inputs)
        return self._points

    def __getitem__(self, i):
        return self._resolve()[i]

    def __len__(self):
        return self._size


G1_SETUP = _LazySetupSide("g1", KZG_SETUP_SIZE)  # noqa: F821
G2_SETUP = _LazySetupSide("g2", KZG_SETUP_SIZE)  # noqa: F821


# ---------------------------------------------------------------------------
# Updated containers (sharding/beacon-chain.md:190-225)
# ---------------------------------------------------------------------------

class AttestationData(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    index: CommitteeIndex  # noqa: F821
    beacon_block_root: Root  # noqa: F821
    source: Checkpoint  # noqa: F821
    target: Checkpoint  # noqa: F821
    shard_blob_root: Root  # [New in Sharding]  # noqa: F821


class Attestation(Container):  # noqa: F821
    aggregation_bits: Bitlist[MAX_VALIDATORS_PER_COMMITTEE]  # noqa: F821
    data: AttestationData
    signature: BLSSignature  # noqa: F821


class IndexedAttestation(Container):  # noqa: F821
    attesting_indices: List[ValidatorIndex, MAX_VALIDATORS_PER_COMMITTEE]  # noqa: F821
    data: AttestationData
    signature: BLSSignature  # noqa: F821


class PendingAttestation(Container):  # noqa: F821
    aggregation_bits: Bitlist[MAX_VALIDATORS_PER_COMMITTEE]  # noqa: F821
    data: AttestationData
    inclusion_delay: Slot  # noqa: F821
    proposer_index: ValidatorIndex  # noqa: F821


class AttesterSlashing(Container):  # noqa: F821
    attestation_1: IndexedAttestation
    attestation_2: IndexedAttestation


# ---------------------------------------------------------------------------
# New containers (sharding/beacon-chain.md:227-403)
# ---------------------------------------------------------------------------

class Builder(Container):  # noqa: F821
    pubkey: BLSPubkey  # noqa: F821


class DataCommitment(Container):  # noqa: F821
    point: BLSCommitment
    samples_count: uint64  # noqa: F821


class AttestedDataCommitment(Container):  # noqa: F821
    commitment: DataCommitment
    root: Root  # noqa: F821
    includer_index: ValidatorIndex  # noqa: F821


class ShardBlobBody(Container):  # noqa: F821
    commitment: DataCommitment
    degree_proof: BLSCommitment
    data: List[BLSPoint, POINTS_PER_SAMPLE * MAX_SAMPLES_PER_BLOB]  # noqa: F821
    max_priority_fee_per_sample: Gwei  # noqa: F821
    max_fee_per_sample: Gwei  # noqa: F821


class ShardBlobBodySummary(Container):  # noqa: F821
    commitment: DataCommitment
    degree_proof: BLSCommitment
    data_root: Root  # noqa: F821
    max_priority_fee_per_sample: Gwei  # noqa: F821
    max_fee_per_sample: Gwei  # noqa: F821


class ShardBlob(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    shard: Shard
    builder_index: BuilderIndex
    proposer_index: ValidatorIndex  # noqa: F821
    body: ShardBlobBody


class ShardBlobHeader(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    shard: Shard
    builder_index: BuilderIndex
    proposer_index: ValidatorIndex  # noqa: F821
    body_summary: ShardBlobBodySummary


class SignedShardBlob(Container):  # noqa: F821
    message: ShardBlob
    signature: BLSSignature  # noqa: F821


class SignedShardBlobHeader(Container):  # noqa: F821
    message: ShardBlobHeader
    signature: BLSSignature  # noqa: F821


class PendingShardHeader(Container):  # noqa: F821
    attested: AttestedDataCommitment
    votes: Bitlist[MAX_VALIDATORS_PER_COMMITTEE]  # noqa: F821
    weight: Gwei  # noqa: F821
    update_slot: Slot  # noqa: F821


class ShardBlobReference(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    shard: Shard
    builder_index: BuilderIndex
    proposer_index: ValidatorIndex  # noqa: F821
    body_root: Root  # noqa: F821


class ShardProposerSlashing(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    shard: Shard
    proposer_index: ValidatorIndex  # noqa: F821
    builder_index_1: BuilderIndex
    builder_index_2: BuilderIndex
    body_root_1: Root  # noqa: F821
    body_root_2: Root  # noqa: F821
    signature_1: BLSSignature  # noqa: F821
    signature_2: BLSSignature  # noqa: F821


class ShardWork(Container):  # noqa: F821
    # SHARD_WORK_UNCONFIRMED | SHARD_WORK_CONFIRMED | SHARD_WORK_PENDING
    status: Union[  # noqa: F821
        None,
        AttestedDataCommitment,
        List[PendingShardHeader, MAX_SHARD_HEADERS_PER_SHARD],  # noqa: F821
    ]


# ---------------------------------------------------------------------------
# Extended beacon containers (sharding/beacon-chain.md:208-225)
# ---------------------------------------------------------------------------

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
    execution_payload: ExecutionPayload  # noqa: F821
    # [New in Sharding]
    shard_proposer_slashings: List[ShardProposerSlashing, MAX_SHARD_PROPOSER_SLASHINGS]  # noqa: F821
    shard_headers: List[SignedShardBlobHeader, MAX_SHARDS * MAX_SHARD_HEADERS_PER_SHARD]  # noqa: F821


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
    latest_execution_payload_header: ExecutionPayloadHeader  # noqa: F821
    # [New in Sharding]
    blob_builders: List[Builder, BLOB_BUILDER_REGISTRY_LIMIT]  # noqa: F821
    blob_builder_balances: List[Gwei, BLOB_BUILDER_REGISTRY_LIMIT]  # noqa: F821
    shard_buffer: Vector[List[ShardWork, MAX_SHARDS], SHARD_STATE_MEMORY_SLOTS]  # noqa: F821
    shard_sample_price: uint64  # noqa: F821


# ---------------------------------------------------------------------------
# Misc helpers (sharding/beacon-chain.md:417-476)
# ---------------------------------------------------------------------------

def next_power_of_two(x: int) -> int:
    return 2 ** ((x - 1).bit_length())


def compute_previous_slot(slot: "Slot") -> "Slot":
    if slot > 0:
        return Slot(slot - 1)
    else:
        return Slot(0)


def compute_updated_sample_price(prev_price: "Gwei", samples_length, active_shards) -> "Gwei":  # noqa: F821
    """EIP-1559-style per-epoch sample-price adjustment
    (sharding/beacon-chain.md:436-446)."""
    adjustment_quotient = int(active_shards) * int(SLOTS_PER_EPOCH) * int(SAMPLE_PRICE_ADJUSTMENT_COEFFICIENT)  # noqa: F821
    prev_price = int(prev_price)
    samples_length = int(samples_length)
    target = int(TARGET_SAMPLES_PER_BLOB)
    if samples_length > target:
        delta = max(1, prev_price * (samples_length - target) // target // adjustment_quotient)
        return Gwei(min(prev_price + delta, int(MAX_SAMPLE_PRICE)))  # noqa: F821
    else:
        delta = max(1, prev_price * (target - samples_length) // target // adjustment_quotient)
        return Gwei(max(prev_price, int(MIN_SAMPLE_PRICE) + delta) - delta)  # noqa: F821


def compute_committee_source_epoch(epoch: "Epoch", period) -> "Epoch":  # noqa: F821
    """Source epoch for period-stable committees (sharding/beacon-chain.md:449-458)."""
    source_epoch = Epoch(epoch - epoch % period)  # noqa: F821
    if source_epoch >= period:
        source_epoch = Epoch(source_epoch - period)  # noqa: F821
    return source_epoch


def batch_apply_participation_flag(state: "BeaconState", bits, epoch: "Epoch",  # noqa: F821
                                   full_committee, flag_index: int) -> None:
    """(sharding/beacon-chain.md:462-474)"""
    if epoch == get_current_epoch(state):  # noqa: F821
        epoch_participation = state.current_epoch_participation
    else:
        epoch_participation = state.previous_epoch_participation
    for bit, index in zip(bits, full_committee):
        if bit:
            epoch_participation[index] = add_flag(epoch_participation[index], flag_index)  # noqa: F821


# ---------------------------------------------------------------------------
# Beacon state accessors (sharding/beacon-chain.md:478-546)
# ---------------------------------------------------------------------------

def get_committee_count_per_slot(state: "BeaconState", epoch: "Epoch"):  # noqa: F821
    """Committees per slot, bounded by the active shard count
    (sharding/beacon-chain.md:478-488)."""
    return max(uint64(1), min(  # noqa: F821
        get_active_shard_count(state, epoch),
        uint64(len(get_active_validator_indices(state, epoch))) // SLOTS_PER_EPOCH // TARGET_COMMITTEE_SIZE,  # noqa: F821
    ))


def get_active_shard_count(state: "BeaconState", epoch: "Epoch"):  # noqa: F821
    return uint64(INITIAL_ACTIVE_SHARDS)  # noqa: F821


def get_shard_proposer_index(state: "BeaconState", slot: "Slot", shard: "Shard") -> "ValidatorIndex":  # noqa: F821
    """(sharding/beacon-chain.md:502-511)"""
    epoch = compute_epoch_at_slot(slot)  # noqa: F821
    seed = hash(get_seed(state, epoch, DOMAIN_SHARD_BLOB) + uint_to_bytes(Slot(slot)) + uint_to_bytes(Shard(shard)))  # noqa: F821
    indices = get_active_validator_indices(state, epoch)  # noqa: F821
    return compute_proposer_index(state, indices, seed)  # noqa: F821


def get_start_shard(state: "BeaconState", slot: "Slot") -> "Shard":  # noqa: F821
    """(sharding/beacon-chain.md:515-524)"""
    epoch = compute_epoch_at_slot(Slot(slot))  # noqa: F821
    committee_count = get_committee_count_per_slot(state, epoch)
    active_shard_count = get_active_shard_count(state, epoch)
    return Shard(committee_count * slot % active_shard_count)


def compute_shard_from_committee_index(state: "BeaconState", slot: "Slot", index) -> "Shard":  # noqa: F821
    active_shards = get_active_shard_count(state, compute_epoch_at_slot(slot))  # noqa: F821
    assert index < active_shards
    return Shard((index + get_start_shard(state, slot)) % active_shards)


def compute_committee_index_from_shard(state: "BeaconState", slot: "Slot", shard: "Shard"):  # noqa: F821
    epoch = compute_epoch_at_slot(slot)  # noqa: F821
    active_shards = get_active_shard_count(state, epoch)
    index = CommitteeIndex((active_shards + shard - get_start_shard(state, slot)) % active_shards)  # noqa: F821
    assert index < get_committee_count_per_slot(state, epoch)
    return index


# ---------------------------------------------------------------------------
# Block processing (sharding/beacon-chain.md:549-807)
# ---------------------------------------------------------------------------

def process_block(state: "BeaconState", block: "BeaconBlock") -> None:  # noqa: F821
    process_block_header(state, block)  # noqa: F821
    # execution is enabled by default post-merge (beacon-chain.md:551-553)
    process_execution_payload(state, block.body.execution_payload, EXECUTION_ENGINE)  # noqa: F821
    process_randao(state, block.body)  # noqa: F821
    process_eth1_data(state, block.body)  # noqa: F821
    process_operations(state, block.body)  # [Modified in Sharding]
    process_sync_aggregate(state, block.body.sync_aggregate)  # noqa: F821


def process_operations(state: "BeaconState", body: "BeaconBlockBody") -> None:  # noqa: F821
    """(sharding/beacon-chain.md:560-585)"""
    assert len(body.deposits) == min(MAX_DEPOSITS, state.eth1_data.deposit_count - state.eth1_deposit_index)  # noqa: F821

    def for_ops(operations, fn):
        for operation in operations:
            fn(state, operation)

    for_ops(body.proposer_slashings, process_proposer_slashing)  # noqa: F821
    for_ops(body.attester_slashings, process_attester_slashing)  # noqa: F821
    for_ops(body.shard_proposer_slashings, process_shard_proposer_slashing)

    # dynamic limit: based on the active shard count
    assert len(body.shard_headers) <= MAX_SHARD_HEADERS_PER_SHARD * get_active_shard_count(state, get_current_epoch(state))  # noqa: F821
    for_ops(body.shard_headers, process_shard_header)

    for_ops(body.attestations, process_attestation)
    for_ops(body.deposits, process_deposit)  # noqa: F821
    for_ops(body.voluntary_exits, process_voluntary_exit)  # noqa: F821


# the base (altair) attestation processing, captured before redefinition
altair_process_attestation = process_attestation  # noqa: F821


def process_attestation(state: "BeaconState", attestation: "Attestation") -> None:  # noqa: F821
    """altair attestation processing + shard-work vote accounting
    (sharding/beacon-chain.md:589-594)."""
    altair_process_attestation(state, attestation)
    process_attested_shard_work(state, attestation)


def process_attested_shard_work(state: "BeaconState", attestation: "Attestation") -> None:  # noqa: F821
    """(sharding/beacon-chain.md:598-671)"""
    attestation_shard = compute_shard_from_committee_index(
        state, attestation.data.slot, attestation.data.index,
    )
    full_committee = get_beacon_committee(state, attestation.data.slot, attestation.data.index)  # noqa: F821

    buffer_index = attestation.data.slot % SHARD_STATE_MEMORY_SLOTS  # noqa: F821
    committee_work = state.shard_buffer[buffer_index][attestation_shard]

    # Skip vote accounting unless the header is pending
    if committee_work.status.selector != SHARD_WORK_PENDING:
        if committee_work.status.selector == SHARD_WORK_CONFIRMED:
            attested = committee_work.status.value
            if attested.root == attestation.data.shard_blob_root:
                batch_apply_participation_flag(state, attestation.aggregation_bits,
                                               attestation.data.target.epoch,
                                               full_committee, TIMELY_SHARD_FLAG_INDEX)
        return

    current_headers = committee_work.status.value

    header_index = len(current_headers)
    for i, header in enumerate(current_headers):
        if attestation.data.shard_blob_root == header.attested.root:
            header_index = i
            break
    # attestations for an unknown header can be valid, they just don't count
    if header_index == len(current_headers):
        return

    pending_header = current_headers[header_index]

    # stale weights (from a previous epoch) are recomputed before updating
    if pending_header.weight != 0 and compute_epoch_at_slot(pending_header.update_slot) < get_current_epoch(state):  # noqa: F821
        pending_header.weight = sum(
            state.validators[index].effective_balance
            for index, bit in zip(full_committee, pending_header.votes) if bit
        )

    pending_header.update_slot = state.slot

    full_committee_balance = Gwei(0)  # noqa: F821
    for i, bit in enumerate(attestation.aggregation_bits):
        weight = state.validators[full_committee[i]].effective_balance
        full_committee_balance += weight
        if bit:
            if not pending_header.votes[i]:
                pending_header.weight += weight
                pending_header.votes[i] = True

    # expedited confirmation at 2/3 of committee balance
    if pending_header.weight * 3 >= full_committee_balance * 2:
        batch_apply_participation_flag(state, pending_header.votes, attestation.data.target.epoch,
                                       full_committee, TIMELY_SHARD_FLAG_INDEX)
        if pending_header.attested.commitment == DataCommitment():
            state.shard_buffer[buffer_index][attestation_shard].status.change(
                selector=SHARD_WORK_UNCONFIRMED, value=None,
            )
        else:
            state.shard_buffer[buffer_index][attestation_shard].status.change(
                selector=SHARD_WORK_CONFIRMED, value=pending_header.attested,
            )


def _degree_proof_pairs(body_summary: "ShardBlobBodySummary"):
    """The degree bound's pairing-product rows — ONE derivation shared by
    the scalar and batched verifiers: e(proof, G2[0]) ==
    e(commitment, G2[-points_count]) as a product-is-one check."""
    from consensus_specs_tpu_torch.crypto.bls.curve import g1_from_bytes

    points_count = int(body_summary.commitment.samples_count) * int(POINTS_PER_SAMPLE)
    if points_count == 0:
        assert bytes(body_summary.degree_proof) == bytes(G1_SETUP[0])
    assert points_count <= len(G2_SETUP)
    proof_pt = g1_from_bytes(bytes(body_summary.degree_proof))
    commit_pt = g1_from_bytes(bytes(body_summary.commitment.point))
    return [
        (proof_pt, G2_SETUP[0]),
        (commit_pt.neg(), G2_SETUP[len(G2_SETUP) - points_count] if points_count else G2_SETUP[0]),
    ]


def verify_degree_proof(body_summary: "ShardBlobBodySummary") -> None:
    """The KZG degree bound (sharding/beacon-chain.md:706-719 + prose at
    :760-766): for points_count committed values, the degree proof commits
    B(X)·X^(MAX_DEGREE+1-points_count), so pairing the proof with G2^0
    must equal pairing the commitment with G2^(MAX_DEGREE+1-points_count)
    = G2_SETUP[-points_count] — impossible to construct if deg(B) >=
    points_count."""
    from consensus_specs_tpu_torch.crypto.bls.pairing import pairing_product

    assert pairing_product(_degree_proof_pairs(body_summary)).is_one()


def verify_degree_proofs(body_summaries) -> None:
    """Batched verify_degree_proof — every shard header of a block
    adjudicated in one bucketed device pairing dispatch
    (ops/kzg_torch.pairing_product_is_one_batch; the scalar
    check above is the reference shape). Raises AssertionError naming
    the failing rows. A row whose points are malformed (undecodable
    bytes, failed structural asserts) or outside the r-torsion is
    REJECTED as failing rather than aborting the batch — the device
    kernel's fast final exponentiation is only exact on the subgroups,
    so off-subgroup inputs never reach it."""
    from consensus_specs_tpu_torch.ops import kzg_torch as _kzg_torch

    body_summaries = list(body_summaries)
    if not body_summaries:
        return
    ok = [False] * len(body_summaries)
    rows, live = [], []
    for i, bs in enumerate(body_summaries):
        try:
            pairs = _degree_proof_pairs(bs)
            for p, _q in pairs:
                assert p.is_infinity or p.in_subgroup(), "G1 point outside the r-torsion"
        except Exception:
            continue  # malformed row: stays False, batch proceeds
        rows.append(pairs)
        live.append(i)
    if rows:
        res = _kzg_torch.pairing_product_is_one_batch(rows)
        for j, i in enumerate(live):
            ok[i] = bool(res[j])
    assert all(ok), f"degree proofs failed: {[i for i, v in enumerate(ok) if not v]}"


def process_shard_header(state: "BeaconState", signed_header: "SignedShardBlobHeader") -> None:  # noqa: F821
    """(sharding/beacon-chain.md:675-758)"""
    header = signed_header.message
    slot = header.slot
    shard = header.shard

    # not from slot 0, not from the future
    assert Slot(0) < slot <= state.slot  # noqa: F821
    header_epoch = compute_epoch_at_slot(slot)  # noqa: F821
    assert header_epoch in [get_previous_epoch(state), get_current_epoch(state)]  # noqa: F821
    shard_count = get_active_shard_count(state, header_epoch)
    assert shard < shard_count
    # a committee must be able to attest this (slot, shard)
    start_shard = get_start_shard(state, slot)
    committee_index = (shard_count + shard - start_shard) % shard_count
    committees_per_slot = get_committee_count_per_slot(state, header_epoch)
    assert committee_index <= committees_per_slot

    # data must still be pending
    committee_work = state.shard_buffer[slot % SHARD_STATE_MEMORY_SLOTS][shard]  # noqa: F821
    assert committee_work.status.selector == SHARD_WORK_PENDING

    # not yet in the pending list
    current_headers = committee_work.status.value
    header_root = hash_tree_root(header)  # noqa: F821
    assert header_root not in [pending_header.attested.root for pending_header in current_headers]

    assert header.proposer_index == get_shard_proposer_index(state, slot, shard)

    # builder + proposer aggregate signature
    blob_signing_root = compute_signing_root(header, get_domain(state, DOMAIN_SHARD_BLOB))  # noqa: F821
    builder_pubkey = state.blob_builders[header.builder_index].pubkey
    proposer_pubkey = state.validators[header.proposer_index].pubkey
    assert bls.FastAggregateVerify([builder_pubkey, proposer_pubkey], blob_signing_root, signed_header.signature)  # noqa: F821

    # length check via the degree proof
    verify_degree_proof(header.body_summary)
    body_summary = header.body_summary

    # EIP-1559 fee: builder pays, base fee burns, priority fee to proposer
    samples = body_summary.commitment.samples_count
    max_fee = body_summary.max_fee_per_sample * samples
    assert state.blob_builder_balances[header.builder_index] >= max_fee

    base_fee = state.shard_sample_price * samples
    assert max_fee >= base_fee

    max_priority_fee = body_summary.max_priority_fee_per_sample * samples
    priority_fee = min(max_fee - base_fee, max_priority_fee)

    state.blob_builder_balances[header.builder_index] -= base_fee + priority_fee
    increase_balance(state, header.proposer_index, priority_fee)  # noqa: F821

    # initialize the pending header
    index = compute_committee_index_from_shard(state, slot, shard)
    committee_length = len(get_beacon_committee(state, slot, index))  # noqa: F821
    initial_votes = Bitlist[MAX_VALIDATORS_PER_COMMITTEE]([0] * committee_length)  # noqa: F821
    pending_header = PendingShardHeader(
        attested=AttestedDataCommitment(
            commitment=body_summary.commitment,
            root=header_root,
            includer_index=get_beacon_proposer_index(state),  # noqa: F821
        ),
        votes=initial_votes,
        weight=0,
        update_slot=state.slot,
    )
    current_headers.append(pending_header)


def process_shard_proposer_slashing(state: "BeaconState", proposer_slashing: "ShardProposerSlashing") -> None:  # noqa: F821
    """(sharding/beacon-chain.md:772-805)"""
    slot = proposer_slashing.slot
    shard = proposer_slashing.shard
    proposer_index = proposer_slashing.proposer_index

    reference_1 = ShardBlobReference(slot=slot, shard=shard,
                                     proposer_index=proposer_index,
                                     builder_index=proposer_slashing.builder_index_1,
                                     body_root=proposer_slashing.body_root_1)
    reference_2 = ShardBlobReference(slot=slot, shard=shard,
                                     proposer_index=proposer_index,
                                     builder_index=proposer_slashing.builder_index_2,
                                     body_root=proposer_slashing.body_root_2)
    assert reference_1 != reference_2

    proposer = state.validators[proposer_index]
    assert is_slashable_validator(proposer, get_current_epoch(state))  # noqa: F821

    # builders are not slashed — the proposer co-signed with them
    builder_pubkey_1 = state.blob_builders[proposer_slashing.builder_index_1].pubkey
    builder_pubkey_2 = state.blob_builders[proposer_slashing.builder_index_2].pubkey
    domain = get_domain(state, DOMAIN_SHARD_PROPOSER, compute_epoch_at_slot(slot))  # noqa: F821
    signing_root_1 = compute_signing_root(reference_1, domain)  # noqa: F821
    signing_root_2 = compute_signing_root(reference_2, domain)  # noqa: F821
    assert bls.FastAggregateVerify([builder_pubkey_1, proposer.pubkey], signing_root_1, proposer_slashing.signature_1)  # noqa: F821
    assert bls.FastAggregateVerify([builder_pubkey_2, proposer.pubkey], signing_root_2, proposer_slashing.signature_2)  # noqa: F821

    slash_validator(state, proposer_index)  # noqa: F821


# ---------------------------------------------------------------------------
# Epoch transition (sharding/beacon-chain.md:810-889)
# ---------------------------------------------------------------------------

def epoch_process_steps():
    return [
        process_pending_shard_confirmations,
        reset_pending_shard_work,
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
    ]


def process_epoch(state: "BeaconState") -> None:  # noqa: F821
    for step in epoch_process_steps():
        step(state)


def process_pending_shard_confirmations(state: "BeaconState") -> None:  # noqa: F821
    """(sharding/beacon-chain.md:833-855)"""
    # applies to the previous epoch; nothing to do at genesis
    if get_current_epoch(state) == GENESIS_EPOCH:  # noqa: F821
        return

    previous_epoch = get_previous_epoch(state)  # noqa: F821
    previous_epoch_start_slot = compute_start_slot_at_epoch(previous_epoch)  # noqa: F821

    for slot in range(previous_epoch_start_slot, previous_epoch_start_slot + SLOTS_PER_EPOCH):  # noqa: F821
        buffer_index = slot % SHARD_STATE_MEMORY_SLOTS  # noqa: F821
        for shard_index in range(len(state.shard_buffer[buffer_index])):
            committee_work = state.shard_buffer[buffer_index][shard_index]
            if committee_work.status.selector == SHARD_WORK_PENDING:
                winning_header = max(committee_work.status.value, key=lambda header: header.weight)
                if winning_header.attested.commitment == DataCommitment():
                    committee_work.status.change(selector=SHARD_WORK_UNCONFIRMED, value=None)
                else:
                    committee_work.status.change(selector=SHARD_WORK_CONFIRMED, value=winning_header.attested)


def reset_pending_shard_work(state: "BeaconState") -> None:  # noqa: F821
    """(sharding/beacon-chain.md:858-889)"""
    next_epoch = get_current_epoch(state) + 1  # noqa: F821
    next_epoch_start_slot = compute_start_slot_at_epoch(next_epoch)  # noqa: F821
    committees_per_slot = get_committee_count_per_slot(state, next_epoch)
    active_shards = get_active_shard_count(state, next_epoch)

    for slot in range(next_epoch_start_slot, next_epoch_start_slot + SLOTS_PER_EPOCH):  # noqa: F821
        buffer_index = slot % SHARD_STATE_MEMORY_SLOTS  # noqa: F821

        state.shard_buffer[buffer_index] = [ShardWork() for _ in range(active_shards)]

        start_shard = get_start_shard(state, slot)
        for committee_index in range(committees_per_slot):
            shard = (start_shard + committee_index) % active_shards
            committee_length = len(get_beacon_committee(state, slot, CommitteeIndex(committee_index)))  # noqa: F821
            state.shard_buffer[buffer_index][shard].status.change(
                selector=SHARD_WORK_PENDING,
                value=List[PendingShardHeader, MAX_SHARD_HEADERS_PER_SHARD]([  # noqa: F821
                    PendingShardHeader(
                        attested=AttestedDataCommitment(),
                        votes=Bitlist[MAX_VALIDATORS_PER_COMMITTEE]([0] * committee_length),  # noqa: F821
                        weight=0,
                        update_slot=slot,
                    )
                ]),
            )
        # shards without committees stay SHARD_WORK_UNCONFIRMED
