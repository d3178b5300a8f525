"""EIP-4844 (proto-danksharding) spec source — delta over bellatrix
(ref: specs/eip4844/{beacon-chain,fork,validator,p2p-interface}.md at
v1.1.10).

Blob transactions carry KZG-committed data; the consensus layer checks
the block's `blob_kzgs` list against the versioned hashes peeked from
execution-payload transactions. The reference leaves the trusted setup
"contents TBD" (eip4844/beacon-chain.md:70-73); here KZG commitments are
fully functional against the deterministic development setup
(crypto/kzg.py — INSECURE, test/dev only), with the batched device FFT
path in ops/fft_torch.py behind the same host-oracle semantics.
"""

# ---------------------------------------------------------------------------
# Custom types (eip4844/beacon-chain.md:40-48)
# ---------------------------------------------------------------------------

class BLSFieldElement(uint256):  # noqa: F821
    pass


Blob = Vector[BLSFieldElement, FIELD_ELEMENTS_PER_BLOB]  # noqa: F821


class VersionedHash(Bytes32):  # noqa: F821
    pass


class KZGCommitment(Bytes48):  # noqa: F821
    pass


# ---------------------------------------------------------------------------
# Constants (eip4844/beacon-chain.md:50-61, fork.md:10-14)
# ---------------------------------------------------------------------------

BLOB_TX_TYPE = 0x05
BLS_MODULUS = 52435875175126190479447740508185965837690552500527637822603658699938581184513
DOMAIN_BLOBS_SIDECAR = Bytes4(bytes.fromhex("0a000000"))  # noqa: F821
# versioned-hash prefix byte for KZG commitments
BLOB_COMMITMENT_VERSION_KZG = b"\x01"


# ---------------------------------------------------------------------------
# Trusted setup (eip4844/beacon-chain.md:65-73 — "TBD" upstream; the
# in-tree development setup stands in; see crypto/kzg.insecure_setup)
# ---------------------------------------------------------------------------

class _LazySetup:
    """Defers the (expensive) setup construction until KZG is first used,
    so spec builds stay fast for the (majority of) tests that never touch
    blobs."""

    def __init__(self, size):
        self._size = int(size)
        self._setup = None

    def get(self):
        if self._setup is None:
            from consensus_specs_tpu_torch.crypto.kzg import insecure_setup

            self._setup = insecure_setup(self._size)
        return self._setup


_KZG = _LazySetup(FIELD_ELEMENTS_PER_BLOB)  # noqa: F821


# ---------------------------------------------------------------------------
# Containers (eip4844/beacon-chain.md:84-101)
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
    blob_kzgs: List[KZGCommitment, MAX_BLOBS_PER_BLOCK]  # [New in EIP-4844]  # noqa: F821


class BeaconBlock(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    proposer_index: ValidatorIndex  # noqa: F821
    parent_root: Root  # noqa: F821
    state_root: Root  # noqa: F821
    body: BeaconBlockBody


class SignedBeaconBlock(Container):  # noqa: F821
    message: BeaconBlock
    signature: BLSSignature  # noqa: F821


# ---------------------------------------------------------------------------
# KZG core (eip4844/beacon-chain.md:105-133)
# ---------------------------------------------------------------------------

def blob_to_kzg(blob: "Blob") -> "KZGCommitment":
    """Commit to the blob's field elements in the Lagrange basis
    (eip4844/beacon-chain.md:111-123). The MSM runs against the
    Lagrange-form setup (KZG_SETUP_LAGRANGE analog)."""
    from consensus_specs_tpu_torch.crypto import kzg as _kzg

    for value in blob:
        assert value < BLS_MODULUS
    return KZGCommitment(_kzg.commit_to_evaluations([int(v) for v in blob], _KZG.get()))


def kzg_to_versioned_hash(kzg: "KZGCommitment") -> "VersionedHash":
    return VersionedHash(BLOB_COMMITMENT_VERSION_KZG + hash(kzg)[1:])


def tx_peek_blob_versioned_hashes(opaque_tx: "Transaction"):  # noqa: F821
    """SSZ-offset peek into a blob transaction's versioned hashes
    (eip4844/beacon-chain.md:138-145)."""
    assert opaque_tx[0] == BLOB_TX_TYPE
    message_offset = 1 + int.from_bytes(opaque_tx[1:5], "little")
    # field offset within SignedBlobTransaction.message: 32+8+32+32+8+4+32+4+4
    # (SSZ offsets are relative to the message start; the reference's draft
    # reads the raw value as absolute — the relative interpretation here is
    # the normative SSZ behavior, simple-serialize.md:105-187)
    blob_versioned_hashes_offset = int.from_bytes(
        opaque_tx[message_offset + 156 : message_offset + 160], "little"
    )
    return [
        VersionedHash(opaque_tx[x : x + 32])
        for x in range(message_offset + blob_versioned_hashes_offset, len(opaque_tx), 32)
    ]


def verify_kzgs_against_transactions(transactions, blob_kzgs) -> bool:
    """(eip4844/beacon-chain.md:149-155)"""
    all_versioned_hashes = []
    for tx in transactions:
        if len(tx) > 0 and tx[0] == BLOB_TX_TYPE:
            all_versioned_hashes.extend(tx_peek_blob_versioned_hashes(tx))
    return all_versioned_hashes == [kzg_to_versioned_hash(kzg) for kzg in blob_kzgs]


# ---------------------------------------------------------------------------
# Block processing (eip4844/beacon-chain.md:160-178)
# ---------------------------------------------------------------------------

def process_blob_kzgs(state: "BeaconState", body: "BeaconBlockBody") -> None:  # noqa: F821
    assert verify_kzgs_against_transactions(body.execution_payload.transactions, body.blob_kzgs)


def process_block(state: "BeaconState", block: "BeaconBlock") -> None:  # noqa: F821
    process_block_header(state, block)  # noqa: F821
    if is_execution_enabled(state, block.body):  # noqa: F821
        process_execution_payload(state, block.body.execution_payload, EXECUTION_ENGINE)  # noqa: F821
    process_randao(state, block.body)  # noqa: F821
    process_eth1_data(state, block.body)  # noqa: F821
    process_operations(state, block.body)  # noqa: F821
    process_sync_aggregate(state, block.body.sync_aggregate)  # noqa: F821
    process_blob_kzgs(state, block.body)  # [New in EIP-4844]


# ---------------------------------------------------------------------------
# Networking configuration (eip4844/p2p-interface.md:42-48)
# ---------------------------------------------------------------------------

MAX_REQUEST_BLOBS_SIDECARS = 2**7  # sidecars per BlobsSidecarsByRange request
MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS = 2**13  # ~1.2 months of data-availability serving


# ---------------------------------------------------------------------------
# Sidecar containers (eip4844/p2p-interface.md:53-68)
# ---------------------------------------------------------------------------

class BlobsSidecar(Container):  # noqa: F821
    beacon_block_root: Root  # noqa: F821
    beacon_block_slot: Slot  # noqa: F821
    blobs: List[Blob, MAX_BLOBS_PER_BLOCK]  # noqa: F821


class SignedBlobsSidecar(Container):  # noqa: F821
    message: BlobsSidecar
    signature: BLSSignature  # noqa: F821


# ---------------------------------------------------------------------------
# Honest-validator surface (eip4844/validator.md:38-134)
# ---------------------------------------------------------------------------

def verify_blobs_sidecar(slot: "Slot", beacon_block_root: "Root",  # noqa: F821
                         expected_kzgs, blobs_sidecar: "BlobsSidecar") -> None:
    """Pin a sidecar to its block and check every blob against the
    block's commitment list (eip4844/validator.md:56-67)."""
    assert slot == blobs_sidecar.beacon_block_slot
    assert beacon_block_root == blobs_sidecar.beacon_block_root
    blobs = blobs_sidecar.blobs
    assert len(expected_kzgs) == len(blobs)
    for kzg, blob in zip(expected_kzgs, blobs):
        assert blob_to_kzg(blob) == kzg


def retrieve_blobs_sidecar(slot: "Slot", beacon_block_root: "Root") -> "BlobsSidecar":  # noqa: F821
    """Test-infra stub for the (implementation-dependent) sidecar store
    (eip4844/validator.md:50-54); tests monkeypatch this. The default
    raises — a block with commitments and no retrievable sidecar is
    NOT available."""
    raise LookupError(f"no blobs sidecar for slot={slot}")


def is_data_available(slot: "Slot", beacon_block_root: "Root", kzgs) -> bool:  # noqa: F821
    """Data-availability gate: the block may be processed optimistically,
    but MUST NOT be considered valid until its sidecar is retrieved and
    verified (eip4844/validator.md:44-54). Returns True/False rather than
    raising so fork-choice callers can gate directly."""
    try:
        sidecar = retrieve_blobs_sidecar(slot, beacon_block_root)
        verify_blobs_sidecar(slot, beacon_block_root, kzgs, sidecar)
    except Exception:
        return False
    return True


def get_blobs_and_kzg_commitments(payload_id):
    """Engine-API stub (eip4844/validator.md:83-101 `get_blobs`): the
    execution engine returns the payload's blobs and their commitments;
    tests monkeypatch this. Unstable upstream API — kzgs first, matching
    the reference's `kzgs, blobs = get_blobs(payload_id)` order."""
    return [], []


def validate_blobs_and_kzg_commitments(execution_payload, blobs, blob_kzgs) -> None:
    """Proposal-time sanity checks before placing commitments in the body
    (eip4844/validator.md:88-99): commitments must match both the payload
    transactions' versioned hashes and the engine-provided blobs."""
    assert verify_kzgs_against_transactions(execution_payload.transactions, blob_kzgs)
    assert len(blob_kzgs) == len(blobs)
    assert all(blob_to_kzg(blob) == kzg for blob, kzg in zip(blobs, blob_kzgs))


def get_blobs_sidecar(block: "BeaconBlock", blobs) -> "BlobsSidecar":  # noqa: F821
    """Package a proposal's blobs for distribution alongside the block
    (eip4844/validator.md:107-118)."""
    return BlobsSidecar(
        beacon_block_root=hash_tree_root(block),  # noqa: F821
        beacon_block_slot=block.slot,
        blobs=blobs,
    )


def get_signed_blobs_sidecar(state: "BeaconState", blobs_sidecar: "BlobsSidecar",  # noqa: F821
                             privkey: int) -> "SignedBlobsSidecar":
    """Proposer-sign the sidecar under DOMAIN_BLOBS_SIDECAR at the
    sidecar's slot epoch (eip4844/validator.md:120-130)."""
    domain = get_domain(  # noqa: F821
        state, DOMAIN_BLOBS_SIDECAR,
        compute_epoch_at_slot(blobs_sidecar.beacon_block_slot),  # noqa: F821
    )
    signing_root = compute_signing_root(blobs_sidecar, domain)  # noqa: F821
    return SignedBlobsSidecar(
        message=blobs_sidecar,
        signature=bls.Sign(privkey, signing_root),  # noqa: F821
    )


# ---------------------------------------------------------------------------
# Gossip validation (eip4844/p2p-interface.md:97-129) — the executable
# REJECT-level conditions; IGNORE-level conditions (clock window, first-
# seen dedup) depend on local node state and stay in the prose doc
# ---------------------------------------------------------------------------

def validate_gossip_beacon_block_kzgs(block: "BeaconBlock") -> bool:  # noqa: F821
    """beacon_block topic [REJECT] additions (p2p-interface.md:101-107):
    each commitment a valid compressed G1 point, and the commitment list
    consistent with the payload's blob transactions."""
    if not all(bls.KeyValidate(bytes(kzg)) for kzg in block.body.blob_kzgs):  # noqa: F821
        return False
    return verify_kzgs_against_transactions(
        block.body.execution_payload.transactions, block.body.blob_kzgs
    )


def validate_gossip_blobs_sidecar(state: "BeaconState",  # noqa: F821
                                  signed_blobs_sidecar: "SignedBlobsSidecar",
                                  proposer_pubkey: "BLSPubkey") -> bool:  # noqa: F821
    """blobs_sidecar topic [REJECT] conditions (p2p-interface.md:113-127):
    well-formed field elements and a valid proposer signature over the
    sidecar. `proposer_pubkey` is resolved by the caller from the block
    proposer of the sidecar's slot."""
    sidecar = signed_blobs_sidecar.message
    for blob in sidecar.blobs:
        for element in blob:
            if not int(element) < BLS_MODULUS:
                return False
    domain = get_domain(  # noqa: F821
        state, DOMAIN_BLOBS_SIDECAR,
        compute_epoch_at_slot(sidecar.beacon_block_slot),  # noqa: F821
    )
    signing_root = compute_signing_root(sidecar, domain)  # noqa: F821
    return bls.Verify(proposer_pubkey, signing_root, signed_blobs_sidecar.signature)  # noqa: F821


# ---------------------------------------------------------------------------
# Req/Resp (eip4844/p2p-interface.md:174-249): BlobsSidecarsByRange v1
# ---------------------------------------------------------------------------

class BlobsSidecarsByRangeRequest(Container):  # noqa: F821
    start_slot: Slot  # noqa: F821
    count: uint64  # noqa: F821


def compute_blobs_serve_range(current_epoch: "Epoch"):  # noqa: F821
    """Epoch range a node MUST serve sidecars for
    (p2p-interface.md:209-231): the trailing
    MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS window, floored at genesis."""
    min_epoch = max(int(GENESIS_EPOCH), int(current_epoch) - MIN_EPOCHS_FOR_BLOBS_SIDECARS_REQUESTS)  # noqa: F821
    return Epoch(min_epoch), current_epoch  # noqa: F821
