"""Data Availability Sampling (R&D) spec source — delta over sharding
(ref: specs/das/{das-core,sampling,fork-choice}.md at v1.1.10).

Extended data = the shard blob's points Reed-Solomon-doubled via the DAS
FFT extension; samples are KZG multi-proof-verified subgroup slices. The
reference leaves `recover_data` and `check_multi_kzg_proof` bodies as
`...`; here both are implemented (crypto/fr.recover_data zero-polynomial
reconstruction, crypto/kzg.check_multi_kzg_proof pairing check), and the
FFT hot path has a fused batched device kernel
(ops/fft_torch.das_extension on kernel K11) bit-identical to the host
oracle.
"""

# ---------------------------------------------------------------------------
# Custom types + config (das-core.md:28-44)
# ---------------------------------------------------------------------------

class SampleIndex(uint64):  # noqa: F821
    pass


# ---------------------------------------------------------------------------
# New containers (das-core.md:46-56)
# ---------------------------------------------------------------------------

class DASSample(Container):  # noqa: F821
    slot: Slot  # noqa: F821
    shard: Shard  # noqa: F821
    index: SampleIndex
    proof: BLSCommitment  # noqa: F821
    data: Vector[BLSPoint, POINTS_PER_SAMPLE]  # noqa: F821


# ---------------------------------------------------------------------------
# Reverse bit ordering + data extension (das-core.md:60-119)
# ---------------------------------------------------------------------------

def reverse_bit_order(n: int, order: int) -> int:
    from consensus_specs_tpu_torch.crypto import fr as _fr

    return _fr.reverse_bit_order(n, order)


def reverse_bit_order_list(elements):
    from consensus_specs_tpu_torch.crypto import fr as _fr

    return _fr.reverse_bit_order_list([int(e) for e in elements])


def fft(values, inv: bool = False):
    from consensus_specs_tpu_torch.crypto import fr as _fr

    return _fr.fft([int(v) for v in values], inv=inv)


def ifft(values):
    return fft(values, inv=True)


def das_fft_extension(data):
    """(das-core.md:90-97)"""
    from consensus_specs_tpu_torch.crypto import fr as _fr

    return _fr.das_fft_extension([int(v) for v in data])


def extend_data(data):
    """(das-core.md:112-119)"""
    from consensus_specs_tpu_torch.crypto import fr as _fr

    return _fr.extend_data([int(v) for v in data])


def unextend_data(extended_data):
    return list(extended_data[: len(extended_data) // 2])


def recover_data(data):
    """(das-core.md:103-110; body `...` upstream — implemented via the
    zero-polynomial erasure recovery in crypto/fr.recover_data)"""
    from consensus_specs_tpu_torch.crypto import fr as _fr

    return _fr.recover_data(
        [None if d is None else [int(v) for v in d] for d in data]
    )


# ---------------------------------------------------------------------------
# KZG glue (das-core.md:121-152)
# ---------------------------------------------------------------------------

def _setup():
    from consensus_specs_tpu_torch.crypto.kzg import insecure_setup

    return insecure_setup(int(KZG_SETUP_SIZE))  # noqa: F821


def check_multi_kzg_proof(commitment, proof, x, ys) -> bool:
    """(das-core.md:131-137; body `...` upstream)"""
    from consensus_specs_tpu_torch.crypto import kzg as _kzg

    return _kzg.check_multi_kzg_proof(
        bytes(commitment), bytes(proof), int(x), [int(y) for y in ys], _setup()
    )


def commit_to_data(data_as_poly):
    """Commit to polynomial coefficients (das-core.md:146-149)."""
    from consensus_specs_tpu_torch.crypto import kzg as _kzg

    return BLSCommitment(_kzg.commit([int(c) for c in data_as_poly], _setup()))  # noqa: F821


def construct_proofs(extended_data_as_poly):
    """Multi-proofs for every sample subgroup of the extended data
    (das-core.md:152-158; upstream `...` refers to FK20 — this builds the
    same proofs directly from the polynomial, one per sample)."""
    from consensus_specs_tpu_torch.crypto import fr as _fr
    from consensus_specs_tpu_torch.crypto import kzg as _kzg

    coeffs = [int(c) for c in extended_data_as_poly]
    n = len(coeffs)
    points_per_sample = int(POINTS_PER_SAMPLE)  # noqa: F821
    sample_count = n // points_per_sample
    setup = _setup()
    w = _fr.root_of_unity(n)
    proofs = []
    # proofs[c] opens the multiplicative coset {w^(c + sample_count*t)}
    # — extended-data sample i maps to c = reverse_bit_order(i) (the coset
    # derivation: extended index i*pps+j sits at natural domain index
    # rbo(j,pps)*sample_count + rbo(i,sample_count))
    for c in range(sample_count):
        x = pow(w, c, _fr.MODULUS)
        xs = [x * pow(w, t * sample_count, _fr.MODULUS) % _fr.MODULUS for t in range(points_per_sample)]
        _, proof = _kzg.open_multi(coeffs, xs, setup)
        proofs.append(BLSCommitment(proof))  # noqa: F821
    return proofs


# ---------------------------------------------------------------------------
# DAS functions (das-core.md:154-190)
# ---------------------------------------------------------------------------

def sample_data(slot, shard, extended_data):
    """(das-core.md:154-175)"""
    from consensus_specs_tpu_torch.crypto import fr as _fr

    points_per_sample = int(POINTS_PER_SAMPLE)  # noqa: F821
    sample_count = len(extended_data) // points_per_sample
    assert sample_count <= int(MAX_SAMPLES_PER_BLOB)  # noqa: F821
    poly = _fr.ifft(_fr.reverse_bit_order_list([int(v) for v in extended_data]))
    assert all(v == 0 for v in poly[len(poly) // 2 :])
    proofs = construct_proofs(poly)
    return [
        DASSample(
            slot=slot,
            shard=shard,
            index=i,
            proof=proofs[reverse_bit_order(i, sample_count)],
            data=[int(v) for v in extended_data[i * points_per_sample : (i + 1) * points_per_sample]],
        )
        for i in range(sample_count)
    ]


def sample_coset_opening(sample, sample_count):
    """(x0, ys) claimed by `sample`: its coset starts at
    x0 = w_n^rbo(index) — rbo_list(sample.data)[j] is the evaluation at
    natural domain index j*sample_count + rbo(index), exactly the coset
    x0·<w_n^sample_count> that check_multi_kzg_proof walks. ONE
    derivation shared by the scalar and batched verifiers (they must
    never disagree on the coset convention)."""
    from consensus_specs_tpu_torch.crypto import fr as _fr

    n = int(sample_count) * int(POINTS_PER_SAMPLE)  # noqa: F821
    domain_pos = reverse_bit_order(int(sample.index), int(sample_count))
    x0 = pow(_fr.root_of_unity(n), domain_pos, _fr.MODULUS)
    return x0, reverse_bit_order_list(sample.data)


def verify_sample(sample, sample_count, commitment):
    """(das-core.md:177-184)"""
    x, ys = sample_coset_opening(sample, sample_count)
    assert check_multi_kzg_proof(commitment.point, sample.proof, x, ys)


def verify_samples(samples, sample_count, commitment):
    """Batched verify_sample — a validator's whole per-slot sampling
    responsibility (das-core.md:177-184 specifies only the scalar check)
    adjudicated in ONE fixed-shape device pairing dispatch
    (ops/kzg_torch.check_multi_kzg_proof_batch): per-sample host work is a
    size-m interpolation commitment, all pairing FLOPs are batched.
    Raises AssertionError if any sample fails (matching verify_sample)."""
    from consensus_specs_tpu_torch.ops import kzg_torch as _kzg_torch

    samples = list(samples)
    if not samples:
        return
    x0s, yss = [], []
    for sample in samples:
        x0, ys = sample_coset_opening(sample, sample_count)
        x0s.append(x0)
        yss.append(ys)
    ok = _kzg_torch.check_multi_kzg_proof_batch(
        [bytes(commitment.point)] * len(samples),
        [bytes(sample.proof) for sample in samples],
        x0s,
        yss,
        _setup(),
    )
    assert bool(ok.all()), f"samples failed verification: {[i for i, v in enumerate(ok) if not v]}"


def reconstruct_extended_data(samples):
    """(das-core.md:186-190)"""
    subgroups = [
        None if sample is None else reverse_bit_order_list(sample.data) for sample in samples
    ]
    return recover_data(subgroups)
