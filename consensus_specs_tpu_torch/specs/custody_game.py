"""Custody game (R&D) spec source — delta over sharding
(ref: specs/custody_game/{beacon-chain,validator}.md at v1.1.10).

Proof of custody: validators periodically reveal period secrets; chunk
challenges force attesters to reproduce attested shard data; the custody
bit (Legendre-PRF over a universal hash of the data atoms) makes lazy
custody provably slashable.

Reconciliation notes — the reference custody document predates the
v1.1.10 sharding rewrite and references retired artifacts; testgen for it
is disabled upstream (tests/generators/operations/main.py:26-34). This
delta keeps the custody semantics intact and reconciles the seams:
- `ShardTransition` / `AttestationData.shard_transition_root` (the old
  sharding shape the challenges prove against) are carried as
  compatibility containers defined here;
- the epoch transition composes custody steps with the v1.1.10 sharding
  epoch steps (the referenced process_pending_headers/
  charge_confirmed_header_fees names are the older spellings of
  process_pending_shard_confirmations/reset_pending_shard_work);
- `process_light_client_aggregate` (never defined anywhere in the
  reference) is omitted from process_block.
"""

# ---------------------------------------------------------------------------
# Constants (custody_game/beacon-chain.md:64-79)
# ---------------------------------------------------------------------------

CUSTODY_PRIME = int(2**256 - 189)
CUSTODY_SECRETS = uint64(3)  # noqa: F821
BYTES_PER_CUSTODY_ATOM = uint64(32)  # noqa: F821
CUSTODY_PROBABILITY_EXPONENT = uint64(10)  # noqa: F821

DOMAIN_CUSTODY_BIT_SLASHING = Bytes4(bytes.fromhex("83000000"))  # noqa: F821

# Size parameters (custody_game/beacon-chain.md:105-110). The old-sharding
# MAX_SHARD_BLOCK_SIZE the document assumes (2**20 bytes) is carried here
# as a compatibility constant.
MAX_SHARD_BLOCK_SIZE = uint64(2**20)  # noqa: F821
BYTES_PER_CUSTODY_CHUNK = uint64(2**12)  # noqa: F821
CUSTODY_RESPONSE_DEPTH = ((int(MAX_SHARD_BLOCK_SIZE) // int(BYTES_PER_CUSTODY_CHUNK)) - 1).bit_length()

MAX_CUSTODY_CHUNK_CHALLENGE_RECORDS = uint64(2**20)  # noqa: F821


# ---------------------------------------------------------------------------
# Compatibility containers (see module docstring)
# ---------------------------------------------------------------------------

class ShardTransition(Container):  # noqa: F821
    """The pre-v1.1.10 sharding transition summary custody challenges
    reference (shard_data_roots[i] is the root of the i-th blob's data)."""
    start_slot: Slot  # noqa: F821
    shard_block_lengths: List[uint64, MAX_SHARD_HEADERS_PER_SHARD]  # noqa: F821
    shard_data_roots: List[Root, MAX_SHARD_HEADERS_PER_SHARD]  # noqa: F821


class AttestationData(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    index: CommitteeIndex  # noqa: F821
    beacon_block_root: Root  # noqa: F821
    source: Checkpoint  # noqa: F821
    target: Checkpoint  # noqa: F821
    shard_blob_root: Root  # noqa: F821
    shard_transition_root: Root  # [Custody compatibility]  # noqa: F821


class Attestation(Container):  # noqa: F821
    aggregation_bits: Bitlist[MAX_VALIDATORS_PER_COMMITTEE]  # noqa: F821
    data: AttestationData
    signature: BLSSignature  # noqa: F821


class IndexedAttestation(Container):  # noqa: F821
    attesting_indices: List[ValidatorIndex, MAX_VALIDATORS_PER_COMMITTEE]  # noqa: F821
    data: AttestationData
    signature: BLSSignature  # noqa: F821


class AttesterSlashing(Container):  # noqa: F821
    attestation_1: IndexedAttestation
    attestation_2: IndexedAttestation


# ---------------------------------------------------------------------------
# Extended types (custody_game/beacon-chain.md:123-158)
# ---------------------------------------------------------------------------

class Validator(Container):  # noqa: F821
    pubkey: BLSPubkey  # noqa: F821
    withdrawal_credentials: Bytes32  # noqa: F821
    effective_balance: Gwei  # noqa: F821
    slashed: boolean  # noqa: F821
    activation_eligibility_epoch: Epoch  # noqa: F821
    activation_epoch: Epoch  # noqa: F821
    exit_epoch: Epoch  # noqa: F821
    withdrawable_epoch: Epoch  # noqa: F821
    # [New in CustodyGame]
    next_custody_secret_to_reveal: uint64  # noqa: F821
    all_custody_secrets_revealed_epoch: Epoch  # noqa: F821


class CustodyChunkChallenge(Container):  # noqa: F821
    responder_index: ValidatorIndex  # noqa: F821
    shard_transition: ShardTransition
    attestation: Attestation
    data_index: uint64  # noqa: F821
    chunk_index: uint64  # noqa: F821


class CustodyChunkChallengeRecord(Container):  # noqa: F821
    challenge_index: uint64  # noqa: F821
    challenger_index: ValidatorIndex  # noqa: F821
    responder_index: ValidatorIndex  # noqa: F821
    inclusion_epoch: Epoch  # noqa: F821
    data_root: Root  # noqa: F821
    chunk_index: uint64  # noqa: F821


class CustodyChunkResponse(Container):  # noqa: F821
    challenge_index: uint64  # noqa: F821
    chunk_index: uint64  # noqa: F821
    chunk: ByteVector[BYTES_PER_CUSTODY_CHUNK]  # noqa: F821
    branch: Vector[Root, CUSTODY_RESPONSE_DEPTH + 1]  # noqa: F821


class CustodySlashing(Container):  # noqa: F821
    data_index: uint64  # noqa: F821
    malefactor_index: ValidatorIndex  # noqa: F821
    malefactor_secret: BLSSignature  # noqa: F821
    whistleblower_index: ValidatorIndex  # noqa: F821
    shard_transition: ShardTransition
    attestation: Attestation
    data: ByteList[MAX_SHARD_BLOCK_SIZE]  # noqa: F821


class SignedCustodySlashing(Container):  # noqa: F821
    message: CustodySlashing
    signature: BLSSignature  # noqa: F821


class CustodyKeyReveal(Container):  # noqa: F821
    revealer_index: ValidatorIndex  # noqa: F821
    reveal: BLSSignature  # noqa: F821


class EarlyDerivedSecretReveal(Container):  # noqa: F821
    revealed_index: ValidatorIndex  # noqa: F821
    epoch: Epoch  # noqa: F821
    reveal: BLSSignature  # noqa: F821
    masker_index: ValidatorIndex  # noqa: F821
    mask: Bytes32  # noqa: F821


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
    shard_proposer_slashings: List[ShardProposerSlashing, MAX_SHARD_PROPOSER_SLASHINGS]  # noqa: F821
    shard_headers: List[SignedShardBlobHeader, MAX_SHARDS * MAX_SHARD_HEADERS_PER_SHARD]  # noqa: F821
    # [New in CustodyGame]
    chunk_challenges: List[CustodyChunkChallenge, MAX_CUSTODY_CHUNK_CHALLENGES]  # noqa: F821
    chunk_challenge_responses: List[CustodyChunkResponse, MAX_CUSTODY_CHUNK_CHALLENGE_RESP]  # noqa: F821
    custody_key_reveals: List[CustodyKeyReveal, MAX_CUSTODY_KEY_REVEALS]  # noqa: F821
    early_derived_secret_reveals: List[EarlyDerivedSecretReveal, MAX_EARLY_DERIVED_SECRET_REVEALS]  # noqa: F821
    custody_slashings: List[SignedCustodySlashing, MAX_CUSTODY_SLASHINGS]  # noqa: F821


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
    blob_builders: List[Builder, BLOB_BUILDER_REGISTRY_LIMIT]  # noqa: F821
    blob_builder_balances: List[Gwei, BLOB_BUILDER_REGISTRY_LIMIT]  # noqa: F821
    shard_buffer: Vector[List[ShardWork, MAX_SHARDS], SHARD_STATE_MEMORY_SLOTS]  # noqa: F821
    shard_sample_price: uint64  # noqa: F821
    # [New in CustodyGame]
    exposed_derived_secrets: Vector[  # noqa: F821
        List[ValidatorIndex, MAX_EARLY_DERIVED_SECRET_REVEALS * SLOTS_PER_EPOCH],  # noqa: F821
        EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS,  # noqa: F821
    ]
    custody_chunk_challenge_records: List[CustodyChunkChallengeRecord, MAX_CUSTODY_CHUNK_CHALLENGE_RECORDS]  # noqa: F821
    custody_chunk_challenge_index: uint64  # noqa: F821


# ---------------------------------------------------------------------------
# Helpers (custody_game/beacon-chain.md:245-357)
# ---------------------------------------------------------------------------

def replace_empty_or_append(l, new_element) -> int:
    for i in range(len(l)):
        if l[i] == type(new_element)():
            l[i] = new_element
            return i
    l.append(new_element)
    return len(l) - 1


def legendre_bit(a: int, q: int) -> int:
    """Legendre symbol (a/q) normalized to a bit
    (custody_game/beacon-chain.md:259-286)."""
    if a >= q:
        return legendre_bit(a % q, q)
    if a == 0:
        return 0
    assert q > a > 0 and q % 2 == 1
    t = 1
    n = q
    while a != 0:
        while a % 2 == 0:
            a //= 2
            r = n % 8
            if r == 3 or r == 5:
                t = -t
        a, n = n, a
        if a % 4 == n % 4 == 3:
            t = -t
        a %= n
    if n == 1:
        return (t + 1) // 2
    else:
        return 0


def get_custody_atoms(bytez: bytes):
    """(custody_game/beacon-chain.md:288-300)"""
    length_remainder = len(bytez) % BYTES_PER_CUSTODY_ATOM
    bytez = bytes(bytez) + b"\x00" * ((BYTES_PER_CUSTODY_ATOM - length_remainder) % BYTES_PER_CUSTODY_ATOM)
    return [
        bytez[i : i + BYTES_PER_CUSTODY_ATOM]
        for i in range(0, len(bytez), BYTES_PER_CUSTODY_ATOM)
    ]


def get_custody_secrets(key: "BLSSignature"):  # noqa: F821
    """Secrets extracted from the G2 signature point's x-coordinate
    (custody_game/beacon-chain.md:302-314; the reference's py_ecc
    `element[0].coeffs` is the affine x's two Fq components)."""
    full_G2_element = bls.signature_to_G2(key)  # noqa: F821
    x, _ = full_G2_element.affine()
    signature = (int(x.c0), int(x.c1))
    signature_bytes = b"".join(v.to_bytes(48, "little") for v in signature)
    secrets = [
        int.from_bytes(signature_bytes[i : i + BYTES_PER_CUSTODY_ATOM], "little")
        for i in range(0, len(signature_bytes), 32)
    ]
    return secrets


def universal_hash_function(data_chunks, secrets) -> int:
    """(custody_game/beacon-chain.md:316-327)"""
    n = len(data_chunks)
    return (
        sum(
            pow(int(secrets[i % CUSTODY_SECRETS]), i, CUSTODY_PRIME) * int.from_bytes(atom, "little") % CUSTODY_PRIME
            for i, atom in enumerate(data_chunks)
        )
        + pow(int(secrets[n % CUSTODY_SECRETS]), n, CUSTODY_PRIME)
    ) % CUSTODY_PRIME


def compute_custody_bit(key: "BLSSignature", data) -> int:  # noqa: F821
    """(custody_game/beacon-chain.md:329-338)"""
    custody_atoms = get_custody_atoms(bytes(data))
    secrets = get_custody_secrets(key)
    uhf = universal_hash_function(custody_atoms, secrets)
    legendre_bits = [
        legendre_bit(uhf + int(secrets[0]) + i, CUSTODY_PRIME)
        for i in range(CUSTODY_PROBABILITY_EXPONENT)
    ]
    return int(all(legendre_bits))


def get_randao_epoch_for_custody_period(period, validator_index) -> "Epoch":  # noqa: F821
    """(custody_game/beacon-chain.md:340-346)"""
    next_period_start = (int(period) + 1) * EPOCHS_PER_CUSTODY_PERIOD - int(validator_index) % EPOCHS_PER_CUSTODY_PERIOD  # noqa: F821
    return Epoch(next_period_start + CUSTODY_PERIOD_TO_RANDAO_PADDING)  # noqa: F821


def get_custody_period_for_validator(validator_index, epoch) -> int:
    """(custody_game/beacon-chain.md:348-356)"""
    return (int(epoch) + int(validator_index) % EPOCHS_PER_CUSTODY_PERIOD) // EPOCHS_PER_CUSTODY_PERIOD  # noqa: F821


# ---------------------------------------------------------------------------
# Block processing (custody_game/beacon-chain.md:360-626)
# ---------------------------------------------------------------------------

sharding_process_block = process_block  # noqa: F821


def process_block(state: "BeaconState", block: "BeaconBlock") -> None:  # noqa: F821
    sharding_process_block(state, block)
    process_custody_game_operations(state, block.body)


def process_custody_game_operations(state: "BeaconState", body: "BeaconBlockBody") -> None:  # noqa: F821
    def for_ops(operations, fn):
        for operation in operations:
            fn(state, operation)

    for_ops(body.chunk_challenges, process_chunk_challenge)
    for_ops(body.chunk_challenge_responses, process_chunk_challenge_response)
    for_ops(body.custody_key_reveals, process_custody_key_reveal)
    for_ops(body.early_derived_secret_reveals, process_early_derived_secret_reveal)
    for_ops(body.custody_slashings, process_custody_slashing)


def process_chunk_challenge(state: "BeaconState", challenge: "CustodyChunkChallenge") -> None:  # noqa: F821
    """(custody_game/beacon-chain.md:391-433)"""
    assert is_valid_indexed_attestation(state, get_indexed_attestation(state, challenge.attestation))  # noqa: F821
    max_attestation_challenge_epoch = Epoch(challenge.attestation.data.target.epoch + MAX_CHUNK_CHALLENGE_DELAY)  # noqa: F821
    assert get_current_epoch(state) <= max_attestation_challenge_epoch  # noqa: F821
    responder = state.validators[challenge.responder_index]
    if responder.exit_epoch < FAR_FUTURE_EPOCH:  # noqa: F821
        assert get_current_epoch(state) <= responder.exit_epoch + MAX_CHUNK_CHALLENGE_DELAY  # noqa: F821
    assert is_slashable_validator(responder, get_current_epoch(state))  # noqa: F821
    attesters = get_attesting_indices(state, challenge.attestation.data, challenge.attestation.aggregation_bits)  # noqa: F821
    assert challenge.responder_index in attesters
    assert hash_tree_root(challenge.shard_transition) == challenge.attestation.data.shard_transition_root  # noqa: F821
    data_root = challenge.shard_transition.shard_data_roots[challenge.data_index]
    for record in state.custody_chunk_challenge_records:
        assert (
            record.data_root != data_root or record.chunk_index != challenge.chunk_index
        )
    shard_block_length = challenge.shard_transition.shard_block_lengths[challenge.data_index]
    transition_chunks = (shard_block_length + BYTES_PER_CUSTODY_CHUNK - 1) // BYTES_PER_CUSTODY_CHUNK
    assert challenge.chunk_index < transition_chunks
    new_record = CustodyChunkChallengeRecord(
        challenge_index=state.custody_chunk_challenge_index,
        challenger_index=get_beacon_proposer_index(state),  # noqa: F821
        responder_index=challenge.responder_index,
        inclusion_epoch=get_current_epoch(state),  # noqa: F821
        data_root=challenge.shard_transition.shard_data_roots[challenge.data_index],
        chunk_index=challenge.chunk_index,
    )
    replace_empty_or_append(state.custody_chunk_challenge_records, new_record)

    state.custody_chunk_challenge_index += 1
    responder.withdrawable_epoch = FAR_FUTURE_EPOCH  # noqa: F821


def process_chunk_challenge_response(state: "BeaconState", response: "CustodyChunkResponse") -> None:  # noqa: F821
    """(custody_game/beacon-chain.md:438-463)"""
    matching_challenges = [
        record for record in state.custody_chunk_challenge_records
        if record.challenge_index == response.challenge_index
    ]
    assert len(matching_challenges) == 1
    challenge = matching_challenges[0]
    assert response.chunk_index == challenge.chunk_index
    assert is_valid_merkle_branch(  # noqa: F821
        leaf=hash_tree_root(response.chunk),  # noqa: F821
        branch=response.branch,
        depth=CUSTODY_RESPONSE_DEPTH + 1,  # +1 for the List length mix-in
        index=response.chunk_index,
        root=challenge.data_root,
    )
    index_in_records = state.custody_chunk_challenge_records.index(challenge)
    state.custody_chunk_challenge_records[index_in_records] = CustodyChunkChallengeRecord()
    proposer_index = get_beacon_proposer_index(state)  # noqa: F821
    increase_balance(state, proposer_index, Gwei(get_base_reward(state, proposer_index) // MINOR_REWARD_QUOTIENT))  # noqa: F821


def process_custody_key_reveal(state: "BeaconState", reveal: "CustodyKeyReveal") -> None:  # noqa: F821
    """(custody_game/beacon-chain.md:468-506)"""
    revealer = state.validators[reveal.revealer_index]
    epoch_to_sign = get_randao_epoch_for_custody_period(revealer.next_custody_secret_to_reveal, reveal.revealer_index)

    custody_reveal_period = get_custody_period_for_validator(reveal.revealer_index, get_current_epoch(state))  # noqa: F821
    # only past periods are revealable, except the exit-period reveal
    is_past_reveal = revealer.next_custody_secret_to_reveal < custody_reveal_period
    is_exited = revealer.exit_epoch <= get_current_epoch(state)  # noqa: F821
    is_exit_period_reveal = (
        revealer.next_custody_secret_to_reveal
        == get_custody_period_for_validator(reveal.revealer_index, revealer.exit_epoch - 1)
    )
    assert is_past_reveal or (is_exited and is_exit_period_reveal)
    assert is_slashable_validator(revealer, get_current_epoch(state))  # noqa: F821

    domain = get_domain(state, DOMAIN_RANDAO, epoch_to_sign)  # noqa: F821
    signing_root = compute_signing_root(Epoch(epoch_to_sign), domain)  # noqa: F821
    assert bls.Verify(revealer.pubkey, signing_root, reveal.reveal)  # noqa: F821

    if is_exited and is_exit_period_reveal:
        revealer.all_custody_secrets_revealed_epoch = get_current_epoch(state)  # noqa: F821
    revealer.next_custody_secret_to_reveal += 1

    proposer_index = get_beacon_proposer_index(state)  # noqa: F821
    increase_balance(  # noqa: F821
        state, proposer_index, Gwei(get_base_reward(state, reveal.revealer_index) // MINOR_REWARD_QUOTIENT)  # noqa: F821
    )


def process_early_derived_secret_reveal(state: "BeaconState", reveal: "EarlyDerivedSecretReveal") -> None:  # noqa: F821
    """(custody_game/beacon-chain.md:511-565)"""
    revealed_validator = state.validators[reveal.revealed_index]
    derived_secret_location = reveal.epoch % EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS  # noqa: F821

    assert reveal.epoch >= get_current_epoch(state) + RANDAO_PENALTY_EPOCHS  # noqa: F821
    assert reveal.epoch < get_current_epoch(state) + EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS  # noqa: F821
    assert not revealed_validator.slashed
    assert reveal.revealed_index not in state.exposed_derived_secrets[derived_secret_location]

    masker = state.validators[reveal.masker_index]
    pubkeys = [revealed_validator.pubkey, masker.pubkey]
    domain = get_domain(state, DOMAIN_RANDAO, reveal.epoch)  # noqa: F821
    signing_roots = [compute_signing_root(root, domain) for root in [Epoch(reveal.epoch), reveal.mask]]  # noqa: F821
    assert bls.AggregateVerify(pubkeys, signing_roots, reveal.reveal)  # noqa: F821

    if reveal.epoch >= get_current_epoch(state) + CUSTODY_PERIOD_TO_RANDAO_PADDING:  # noqa: F821
        # early enough to be a valid custody round key: full slashing
        slash_validator(state, reveal.revealed_index, reveal.masker_index)  # noqa: F821
    else:
        # small penalty proportional to the max proposer slot reward
        max_proposer_slot_reward = (
            get_base_reward(state, reveal.revealed_index)  # noqa: F821
            * SLOTS_PER_EPOCH  # noqa: F821
            // len(get_active_validator_indices(state, get_current_epoch(state)))  # noqa: F821
            // PROPOSER_REWARD_QUOTIENT  # noqa: F821
        )
        penalty = Gwei(  # noqa: F821
            max_proposer_slot_reward
            * EARLY_DERIVED_SECRET_REVEAL_SLOT_REWARD_MULTIPLE  # noqa: F821
            * (len(state.exposed_derived_secrets[derived_secret_location]) + 1)
        )

        proposer_index = get_beacon_proposer_index(state)  # noqa: F821
        whistleblower_index = reveal.masker_index
        whistleblowing_reward = Gwei(penalty // WHISTLEBLOWER_REWARD_QUOTIENT)  # noqa: F821
        proposer_reward = Gwei(whistleblowing_reward // PROPOSER_REWARD_QUOTIENT)  # noqa: F821
        increase_balance(state, proposer_index, proposer_reward)  # noqa: F821
        increase_balance(state, whistleblower_index, whistleblowing_reward - proposer_reward)  # noqa: F821
        decrease_balance(state, reveal.revealed_index, penalty)  # noqa: F821

        state.exposed_derived_secrets[derived_secret_location].append(reveal.revealed_index)


def process_custody_slashing(state: "BeaconState", signed_custody_slashing: "SignedCustodySlashing") -> None:  # noqa: F821
    """(custody_game/beacon-chain.md:570-626)"""
    custody_slashing = signed_custody_slashing.message
    attestation = custody_slashing.attestation

    # any signed custody-slashing results in at least one slashing
    malefactor = state.validators[custody_slashing.malefactor_index]
    whistleblower = state.validators[custody_slashing.whistleblower_index]
    domain = get_domain(state, DOMAIN_CUSTODY_BIT_SLASHING, get_current_epoch(state))  # noqa: F821
    signing_root = compute_signing_root(custody_slashing, domain)  # noqa: F821
    assert bls.Verify(whistleblower.pubkey, signing_root, signed_custody_slashing.signature)  # noqa: F821
    assert is_slashable_validator(whistleblower, get_current_epoch(state))  # noqa: F821
    assert is_slashable_validator(malefactor, get_current_epoch(state))  # noqa: F821

    assert is_valid_indexed_attestation(state, get_indexed_attestation(state, attestation))  # noqa: F821

    shard_transition = custody_slashing.shard_transition
    assert hash_tree_root(shard_transition) == attestation.data.shard_transition_root  # noqa: F821
    assert len(custody_slashing.data) == shard_transition.shard_block_lengths[custody_slashing.data_index]
    assert hash_tree_root(custody_slashing.data) == shard_transition.shard_data_roots[custody_slashing.data_index]  # noqa: F821
    attesters = get_attesting_indices(state, attestation.data, attestation.aggregation_bits)  # noqa: F821
    assert custody_slashing.malefactor_index in attesters

    # verify the malefactor custody key
    epoch_to_sign = get_randao_epoch_for_custody_period(
        get_custody_period_for_validator(custody_slashing.malefactor_index, attestation.data.target.epoch),
        custody_slashing.malefactor_index,
    )
    domain = get_domain(state, DOMAIN_RANDAO, epoch_to_sign)  # noqa: F821
    signing_root = compute_signing_root(Epoch(epoch_to_sign), domain)  # noqa: F821
    assert bls.Verify(malefactor.pubkey, signing_root, custody_slashing.malefactor_secret)  # noqa: F821

    computed_custody_bit = compute_custody_bit(custody_slashing.malefactor_secret, custody_slashing.data)
    if computed_custody_bit == 1:
        # slash the malefactor, reward the other committee members
        slash_validator(state, custody_slashing.malefactor_index)  # noqa: F821
        committee = get_beacon_committee(state, attestation.data.slot, attestation.data.index)  # noqa: F821
        others_count = len(committee) - 1
        whistleblower_reward = Gwei(malefactor.effective_balance // WHISTLEBLOWER_REWARD_QUOTIENT // others_count)  # noqa: F821
        for attester_index in attesters:
            if attester_index != custody_slashing.malefactor_index:
                increase_balance(state, attester_index, whistleblower_reward)  # noqa: F821
    else:
        # false claim: the custody bit was correct — slash the whistleblower
        slash_validator(state, custody_slashing.whistleblower_index)  # noqa: F821


# ---------------------------------------------------------------------------
# Epoch transition (custody_game/beacon-chain.md:630-709, reconciled with
# the v1.1.10 sharding steps — see module docstring)
# ---------------------------------------------------------------------------

def epoch_process_steps():
    return [
        process_pending_shard_confirmations,  # noqa: F821
        reset_pending_shard_work,  # noqa: F821
        process_justification_and_finalization,  # noqa: F821
        process_inactivity_updates,  # noqa: F821
        process_rewards_and_penalties,  # noqa: F821
        process_registry_updates,  # noqa: F821
        process_reveal_deadlines,
        process_challenge_deadlines,
        process_slashings,  # noqa: F821
        process_eth1_data_reset,  # noqa: F821
        process_effective_balance_updates,  # noqa: F821
        process_slashings_reset,  # noqa: F821
        process_randao_mixes_reset,  # noqa: F821
        process_historical_roots_update,  # noqa: F821
        process_participation_flag_updates,  # noqa: F821
        process_sync_committee_updates,  # noqa: F821
        process_custody_final_updates,
    ]


def process_epoch(state: "BeaconState") -> None:  # noqa: F821
    for step in epoch_process_steps():
        step(state)


def process_reveal_deadlines(state: "BeaconState") -> None:  # noqa: F821
    """(custody_game/beacon-chain.md:668-675)"""
    epoch = get_current_epoch(state)  # noqa: F821
    for index, validator in enumerate(state.validators):
        deadline = validator.next_custody_secret_to_reveal + 1
        if get_custody_period_for_validator(ValidatorIndex(index), epoch) > deadline:  # noqa: F821
            slash_validator(state, ValidatorIndex(index))  # noqa: F821


def process_challenge_deadlines(state: "BeaconState") -> None:  # noqa: F821
    """(custody_game/beacon-chain.md:677-683)"""
    for custody_chunk_challenge in state.custody_chunk_challenge_records:
        if get_current_epoch(state) > custody_chunk_challenge.inclusion_epoch + EPOCHS_PER_CUSTODY_PERIOD:  # noqa: F821
            slash_validator(state, custody_chunk_challenge.responder_index, custody_chunk_challenge.challenger_index)  # noqa: F821
            index_in_records = state.custody_chunk_challenge_records.index(custody_chunk_challenge)
            state.custody_chunk_challenge_records[index_in_records] = CustodyChunkChallengeRecord()


def process_custody_final_updates(state: "BeaconState") -> None:  # noqa: F821
    """(custody_game/beacon-chain.md:688-709)"""
    # clean up exposed RANDAO key reveals
    state.exposed_derived_secrets[get_current_epoch(state) % EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS] = []  # noqa: F821

    records = state.custody_chunk_challenge_records
    validator_indices_in_records = set(int(record.responder_index) for record in records)
    for index, validator in enumerate(state.validators):
        if validator.exit_epoch != FAR_FUTURE_EPOCH:  # noqa: F821
            not_all_secrets_are_revealed = validator.all_custody_secrets_revealed_epoch == FAR_FUTURE_EPOCH  # noqa: F821
            if ValidatorIndex(index) in validator_indices_in_records or not_all_secrets_are_revealed:  # noqa: F821
                validator.withdrawable_epoch = FAR_FUTURE_EPOCH  # noqa: F821
            else:
                if validator.withdrawable_epoch == FAR_FUTURE_EPOCH:  # noqa: F821
                    validator.withdrawable_epoch = Epoch(  # noqa: F821
                        validator.all_custody_secrets_revealed_epoch + config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY  # noqa: F821
                    )
