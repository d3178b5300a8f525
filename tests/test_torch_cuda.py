"""The port's kernels on the card — SHA-256 (K1/K2), the base field
(K3 fq_mul, K4 fq_addsub), the pow chains (K5 fq_pow, K6 fq2_pow), the
static scalar ladders (K7 g1_mul_static, K8 g2_mul_static), the inversion
(K9 fq_inv), the engine's flag deltas (K10 flag_deltas), the Fr transform
and product (K11 fr_fft, K12 fr_mul) and the liveness probe — held against
their plain PyTorch versions, hashlib and Python integers, and the Verify
family and the KZG verifiers on the card (scalar and batched) against the
host oracle. These need
a CUDA card and skip without one; on the card run them with

    python3 -m pytest --noconftest -p no:randomly tests/test_torch_cuda.py
"""
import hashlib

import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch import engine, probe
from consensus_specs_tpu_torch.crypto.bls import ciphersuite as host
from consensus_specs_tpu_torch.engine import delta_checks as dc
from consensus_specs_tpu_torch.engine import ops_torch, stages
from consensus_specs_tpu_torch import harness
from consensus_specs_tpu_torch.crypto import fr as host_fr
from consensus_specs_tpu_torch.crypto import kzg
from consensus_specs_tpu_torch.ops import bls_torch, fft_torch, fq, fq_cuda, fq_plain, fr_cuda, fr_plain, kzg_torch
from consensus_specs_tpu_torch.ops import tower
from consensus_specs_tpu_torch.ops import curve_torch as cj
from consensus_specs_tpu_torch.ops import ladder_checks as lc
from consensus_specs_tpu_torch.ops import sha256 as tdev
from consensus_specs_tpu_torch.ops import sha256_cuda, sha256_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["sha256_blocks", "sha256_raw_blocks"])
@pytest.mark.parametrize("n", [1, 255, 257, 4099])
def test_kernel_matches_plain_version(card, name, n):
    g = torch.Generator().manual_seed(n)
    blocks = torch.randint(-(2**31), 2**31, (n, 16), dtype=torch.int32, generator=g)
    before = sha256_cuda.launches[name]
    got = getattr(sha256_cuda, name)(blocks.to(card))
    torch.cuda.synchronize()
    assert sha256_cuda.launches[name] == before + 1
    assert torch.equal(got.cpu(), getattr(sha256_plain, name)(blocks))


def test_seams_on_the_card_match_hashlib(card):
    data = bytes(range(256)) * 64
    want = b"".join(hashlib.sha256(data[64 * i : 64 * i + 64]).digest() for i in range(len(data) // 64))
    assert tdev.hash_many_device(data) == want
    msgs = [data[:k] for k in range(56)]
    assert tdev.hash_small_device(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    chunks = data[: 32 * 100]
    assert tdev.merkle_root_device(chunks, 128) == tdev.merkle_root_device(chunks, 128, device="cpu")
    assert tdev.tree_levels_device(chunks) == tdev.tree_levels_device(chunks, device="cpu")
    assert tdev.item_roots_device(data[: 32 * 64], 8) == tdev.item_roots_device(data[: 32 * 64], 8, device="cpu")


P = fq.P_INT
RINV = pow(1 << 384, -1, P)
REF = {"mul": lambda x, y: x * y * RINV % P, "add": lambda x, y: (x + y) % P,
       "sub": lambda x, y: (x - y) % P, "neg": lambda x, y: (-y) % P}
CODE = {"add": 0, "sub": 1, "neg": 2}
_EDGE = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (1 << 380) - 1, 1 << 380, (1 << 371) - 1, int("FFF" * 31, 16)]
# every pair of edge values (a - b with a < b among them), sums just below,
# at and just above p, and carries and borrows through every lane of a group
EDGE_PAIRS = [(x, y) for x in _EDGE for y in _EDGE] + [
    (x, (P + d - x) % P) for x in (1, 5, P // 2, (1 << 380) - 1) for d in (-1, 0, 1)]


def _field(n, seed):
    """n operand pairs: random values, with the edge pairs as the last
    rows where n has room for them."""
    rng = np.random.default_rng(seed)
    edges = EDGE_PAIRS if n >= 2 * len(EDGE_PAIRS) else []
    pairs = [tuple(int.from_bytes(rng.bytes(48), "big") % P for _ in range(2))
             for _ in range(n - len(edges))] + edges
    av, bv = [x for x, _ in pairs], [y for _, y in pairs]
    return torch.from_numpy(fq.to_limbs(av)), torch.from_numpy(fq.to_limbs(bv)), av, bv


def _kernel(op, variant="main"):
    """The K3/K4 wrapper of ``variant``: the main path's lane-group kernel
    or ``thread``, the one-thread kernel kept for measurement."""
    if op == "mul":
        return {"main": fq_cuda.fq_mul, "thread": fq_cuda.fq_mul_thread}[variant]
    code = CODE[op]
    return {"main": lambda a, b: fq_cuda.fq_addsub(a, b, code),
            "thread": lambda a, b: fq_cuda.fq_addsub_thread(a, b, code)}[variant]


def _plain(op, a, b):
    return fq_plain.mul(a, b) if op == "mul" else fq_plain.addsub(a, b, CODE[op])


@pytest.mark.parametrize("n", [1, 31, 255, 4609, 16384])
@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg"])
def test_field_kernels_match_plain_versions(card, n, op):
    a, b, av, bv = _field(n, n)
    name = "fq_mul" if op == "mul" else "fq_addsub"
    before, sized = fq_cuda.launches[name], fq_cuda.sizes[name].get(n, 0)
    got = _kernel(op)(a.to(card), b.to(card))
    torch.cuda.synchronize()
    assert fq_cuda.launches[name] == before + 1 and fq_cuda.sizes[name][n] == sized + 1
    assert torch.equal(got.cpu(), _plain(op, a, b))
    assert list(fq.from_limbs(got.cpu())) == [REF[op](x, y) for x, y in zip(av, bv)]


@pytest.mark.parametrize("position", [0, 1])
@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg"])
def test_field_kernels_broadcast_a_single_operand(card, op, position):
    a, b, _, _ = _field(64, 7)
    c = b[:1]  # one element for the whole batch: read with stride 0
    x, y = (c, a.view(8, 8, 32)) if position == 0 else (a.view(8, 8, 32), c)
    got = _kernel(op)(x.to(card), y.to(card))
    assert got.shape == (8, 8, 32)
    assert torch.equal(got.cpu(), _plain(op, x, y))


@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg"])
def test_one_thread_kernels_equal_the_lane_group_kernels(card, op):
    a, b, _, _ = _field(4609, 3)
    a, b = a.to(card), b.to(card)
    assert torch.equal(_kernel(op)(a, b), _kernel(op, "thread")(a, b))
    assert torch.equal(_kernel(op, "thread")(a[:1], b), _kernel(op)(a[:1], b))  # stride 0


def _pow_operand(n, degree, seed):
    """n random elements of Fq (degree 1) or Fq2, with the edge values as
    the last rows where n has room for them."""
    ints = fq_plain.pow_values(n, degree, np.random.default_rng(seed))
    return torch.from_numpy(fq.to_limbs(ints)), ints


_POW = {1: ("fq_pow", fq_cuda.fq_pow, fq_plain.pow_bits), 2: ("fq2_pow", fq_cuda.fq2_pow, fq_plain.fq2_pow_bits)}


@pytest.mark.parametrize("exponent", list(fq_plain.EXPONENTS))
@pytest.mark.parametrize("n", [1, 31, 130, 260, 4609, 16385])
@pytest.mark.parametrize("degree", [1, 2])
def test_pow_kernels_match_plain_versions(card, degree, n, exponent):
    name, kernel, plain = _POW[degree]
    a, ints = _pow_operand(n, degree, n)
    e = fq_plain.EXPONENTS[exponent]
    bits, x = fq_plain.bits_msb(e), a.to(card)
    before, sized = fq_cuda.launches[name], fq_cuda.sizes[name].get(n, 0)
    got = kernel(x, bits)
    torch.cuda.synchronize()
    assert fq_cuda.launches[name] == before + 1 and fq_cuda.sizes[name][n] == sized + 1
    assert torch.equal(got, plain(x, bits))  # the plain version on the card
    sample = sorted(set(range(0, n, max(1, n // 64))) | set(range(max(0, n - len(fq_plain.POW_EDGES[degree])), n)))
    want = [fq_plain.pow_int(ints[i], e, degree) for i in sample]
    values = fq.from_limbs(got[sample].cpu())
    assert (list(values) if degree == 1 else [tuple(v) for v in values]) == want


@pytest.mark.parametrize("degree", [1, 2])
def test_pow_kernels_take_any_shape(card, degree):
    name, kernel, plain = _POW[degree]
    a, _ = _pow_operand(8, degree, 5)
    bits = fq_plain.bits_msb(fq_plain.EXPONENTS["inv"])
    one = a[:1].to(card)
    for x in (one[0], one.expand((8,) + one.shape[1:]), a.to(card).view((2, 4) + a.shape[1:])):
        got = kernel(x, bits)
        assert got.shape == x.shape and torch.equal(got, plain(x, bits))


def test_seams_take_the_pow_kernels_on_the_card(card):
    a, _ = _pow_operand(4, 1, 9)
    a2, _ = _pow_operand(4, 2, 9)
    bits = fq_plain.bits_msb(fq_plain.EXPONENTS["sqrt_a1"])
    sqrt_bits = fq_plain.bits_msb(fq_plain.EXPONENTS["sqrt"])
    before = dict(fq_cuda.launches)
    x = cj.fq_pow_bits(a.to(card), sqrt_bits)
    y = tower.fq2_pow_bits(a2.to(card), bits)
    assert fq_cuda.launches["fq_pow"] == before["fq_pow"] + 1 and fq_cuda.launches["fq2_pow"] == before["fq2_pow"] + 1
    assert fq_cuda.launches["fq_mul"] == before["fq_mul"] and fq_cuda.launches["fq_addsub"] == before["fq_addsub"]
    assert torch.equal(x.cpu(), fq.pow_bits(a, sqrt_bits)) and torch.equal(y.cpu(), tower.fq2_pow_bits(a2, bits))


# K9's inputs: random values, then the edge values (every value of the K3/K4
# edge pairs, 0 included, and pow's edge values) where n has room
_INV_EDGES = list(dict.fromkeys([v for pair in EDGE_PAIRS for v in pair] + fq_plain.POW_EDGES[1]))
_P_MINUS_2 = fq_plain.bits_msb(P - 2)


def _inv_operand(n, seed):
    rng = np.random.default_rng(seed)
    tail = _INV_EDGES if n >= 2 * len(_INV_EDGES) else []
    ints = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(n - len(tail))] + tail
    return torch.from_numpy(fq.to_limbs(ints)), ints


@pytest.mark.parametrize("n", [1, 130, 260, 16385])
def test_inverse_kernel_matches_plain_version(card, n):
    """K9: one launch, bit-exact against its plain version (Fermat's a^(p-2)
    on the card) and, on a sample and every edge row, against Python
    integers."""
    a, ints = _inv_operand(n, n)
    x = a.to(card)
    before, sized = fq_cuda.launches["fq_inv"], fq_cuda.sizes["fq_inv"].get(n, 0)
    got = fq_cuda.fq_inv(x)
    torch.cuda.synchronize()
    assert fq_cuda.launches["fq_inv"] == before + 1 and fq_cuda.sizes["fq_inv"][n] == sized + 1
    assert torch.equal(got, fq_plain.pow_bits(x, _P_MINUS_2))
    edges = len(_INV_EDGES) if n >= 2 * len(_INV_EDGES) else 0
    sample = sorted(set(range(0, n, max(1, n // 64))) | set(range(n - edges, n)))
    assert list(fq.from_limbs(got[sample].cpu())) == [fq_plain.pow_int(ints[i], P - 2, 1) for i in sample]


def test_inverse_kernel_takes_any_shape(card):
    a, _ = _inv_operand(8, 5)
    one = a[:1].to(card)
    for x in (one[0], one.expand(8, 32), a.to(card).view(2, 4, 32), a.to(card)[::2]):
        got = fq_cuda.fq_inv(x)
        assert got.shape == x.shape and torch.equal(got, fq_plain.pow_bits(x, _P_MINUS_2))


def test_seams_take_the_inverse_kernel_on_the_card(card):
    """fq.inv, tower.fq2_inv and jac_to_affine each launch K9 once and K5
    not at all, with the limbs of their CPU runs."""
    a, _ = _inv_operand(4, 9)
    a2, _ = _pow_operand(4, 2, 9)
    pt, _ = lc.ladder_points(4, False, np.random.default_rng(9), "cpu")
    for call, arg in ((fq.inv, a), (tower.fq2_inv, a2), (lambda p: cj.jac_to_affine(cj.FQ, p), pt)):
        before = dict(fq_cuda.launches)
        got = call(arg.to(card) if isinstance(arg, torch.Tensor) else tuple(t.to(card) for t in arg))
        assert fq_cuda.launches["fq_inv"] == before["fq_inv"] + 1 and fq_cuda.launches["fq_pow"] == before["fq_pow"]
        want = call(arg)
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g.cpu(), w)


_LADDER = {False: ("g1_mul_static", cj.FQ), True: ("g2_mul_static", cj.FQ2)}
K_RANDOM = 0x2B3C4D5E6F708192


@pytest.mark.parametrize("k", [cj.X_PARAM, K_RANDOM], ids=["x", "random"])
@pytest.mark.parametrize("n", [1, 130, 16385])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_ladder_kernels_match_plain_version(card, g2, n, k):
    """K7/K8: one launch a ladder and no K3/K4 launch, bit-exact against
    the plain version on the card, the points of a sample and of every edge
    row equal to the host oracle's."""
    name, F = _LADDER[g2]
    pt, hosts = lc.ladder_points(n, g2, np.random.default_rng([n, g2]), card)
    before = dict(fq_cuda.launches)
    got = cj.scalar_mul_static(F, pt, k)
    torch.cuda.synchronize()
    assert fq_cuda.launches[name] == before[name] + 1
    assert all(fq_cuda.launches[m] == before[m] for m in fq_cuda.KERNELS if m != name)
    want = cj.scalar_mul_static_plain(F, pt, k)
    assert all(fq_cuda.launches[m] == before[m] + (m == name) for m in fq_cuda.KERNELS)  # the plain run launches none
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    edges = len(lc.ladder_edges(g2)) if n >= 16 else 0
    sample = sorted(set(range(0, n, max(1, n // 16))) | set(range(n - edges, n)))
    assert lc.limbs_to_ints(got, g2, sample) == [lc.point_ints(hosts[i].mul(k)) for i in sample]


def test_subgroup_masks_on_the_card(card):
    """The G1/G2 subgroup tests, each a K7/K8 ladder on the card, decide
    valid and off-subgroup points as on the CPU."""
    for g2, mask in ((False, cj.g1_subgroup_mask), (True, cj.g2_subgroup_mask)):
        pt, hosts = lc.ladder_points(20, g2, np.random.default_rng(11), "cpu", distinct=4)
        name = _LADDER[g2][0]
        before = fq_cuda.launches[name]
        got = mask(tuple(t.to(card) for t in pt))
        assert fq_cuda.launches[name] == before + (2 if not g2 else 1)
        assert got.tolist() == mask(pt).tolist() == [h.in_subgroup() for h in hosts]


def test_probe_kernel(card):
    before = probe.launches["add_one"]
    assert probe.probe()["ok"]
    assert probe.launches["add_one"] == before + 1


def test_cold_fast_aggregate_verify_on_the_card(card):
    sks = list(range(1, 9))
    pks = [host.SkToPk(k) for k in sks]
    msgs = [bytes([9, i]) * 16 for i in range(4)]
    sigs = [host.Aggregate([host.Sign(k, m) for k in sks[i : i + 4]]) for i, m in enumerate(msgs)]
    pklists = [pks[i : i + 4] for i in range(4)]
    msgs[1] = b"\x99" * 32  # wrong message
    sigs[2] = b"\x00" * 96  # malformed signature
    bls_torch.use_device(card)
    before = dict(fq_cuda.launches)
    got = bls_torch.fast_aggregate_verify_batch_cold(pklists, msgs, sigs)
    want = [host.FastAggregateVerify(pk, m, s) for pk, m, s in zip(pklists, msgs, sigs)]
    assert got.tolist() == want == [True, False, False, True]
    assert all(fq_cuda.launches[k] > before[k] for k in fq_cuda.KERNELS)


def test_scalar_and_batched_verify_family_on_the_card(card):
    sks = list(range(1, 7))
    pks = [host.SkToPk(k) for k in sks]
    msgs = [bytes([5, i]) * 16 for i in range(3)]
    sig = host.Sign(sks[0], msgs[0])
    fav = host.Aggregate([host.Sign(k, msgs[1]) for k in sks[:3]])
    av = host.Aggregate([host.Sign(k, m) for k, m in zip(sks[3:], msgs)])
    bls_torch.use_device(card)
    for name, args in (
        ("Verify", (pks[0], msgs[0], sig)),
        ("Verify", (pks[1], msgs[0], sig)),
        ("FastAggregateVerify", (pks[:3], msgs[1], fav)),
        ("FastAggregateVerify", (pks[:3], msgs[0], fav)),
        ("AggregateVerify", (pks[3:], msgs, av)),
        ("AggregateVerify", (pks[3:], msgs[::-1], av)),
        ("AggregateVerify", (pks[3:], msgs[:2], av)),
    ):
        assert getattr(bls_torch, name)(*args) == getattr(host, name)(*args), (name, args)
    rows = [(pks[0], msgs[0], sig), (pks[2], msgs[0], sig), (pks[0], msgs[0], b"\x00" * 96)]
    assert bls_torch.verify_batch(*zip(*rows)).tolist() == [host.Verify(*r) for r in rows] == [True, False, False]
    rows = [(pks[3:], msgs, av), (pks[3:], msgs[::-1], av), ([], [], av)]
    assert bls_torch.aggregate_verify_batch(*zip(*rows)).tolist() == [host.AggregateVerify(*r) for r in rows]


def _delta_columns(card, n, seed):
    cols = dc.columns(n, seed)
    return cols, (torch.from_numpy(cols[0].view(np.int64)).to(card), torch.from_numpy(cols[1]).to(card),
                  torch.from_numpy(cols[2]).to(card))


@pytest.mark.parametrize("penalize", [True, False], ids=["penalize", "no-penalty"])
@pytest.mark.parametrize("leak", [False, True], ids=["finalizing", "leaking"])
@pytest.mark.parametrize("n", [1, 255, 4099, 1 << 19])
def test_flag_deltas_kernel_matches_plain_version(card, n, leak, penalize):
    for seed, scalars in enumerate(dc.SCALARS):
        cols, t = _delta_columns(card, n, seed)
        before = ops_torch.launches["flag_deltas"]
        got = ops_torch.flag_deltas_cuda(*t, *scalars, leak, penalize)
        want = ops_torch.flag_deltas_plain(*t, *scalars, leak, penalize)
        torch.cuda.synchronize()
        assert ops_torch.launches["flag_deltas"] == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        sample = slice(0, 64) if n > 64 else slice(None)
        ints = dc.python_deltas(*(c[sample] for c in cols), *scalars, leak, penalize)
        assert [g[sample].cpu().numpy().view(np.uint64).tolist() for g in got] == list(ints)


@pytest.mark.parametrize("penalize", [True, False], ids=["penalize", "no-penalty"])
@pytest.mark.parametrize("leak", [False, True], ids=["finalizing", "leaking"])
def test_flag_deltas_kernel_past_int64_matches_python_integers(card, leak, penalize):
    cols, t = _delta_columns(card, 4099, 11)
    got = ops_torch.flag_deltas_cuda(*t, *dc.SCALARS_PAST_INT64, leak, penalize)
    want = dc.python_deltas(*cols, *dc.SCALARS_PAST_INT64, leak, penalize)
    assert [g.cpu().numpy().view(np.uint64).tolist() for g in got] == list(want)


def test_engine_torch_backend_launches_the_kernel(card):
    cols = dc.columns(1 << 13, 3)
    args = (*cols, *dc.SCALARS[0], False, True)
    engine.use_backend("numpy")
    want = stages._flag_deltas(*args)
    try:
        assert engine.use_backend("torch") == "torch"
        before = ops_torch.launches["flag_deltas"]
        got = stages._flag_deltas(*args)
        assert ops_torch.launches["flag_deltas"] == before + 1
        past = (*cols, *dc.SCALARS_PAST_INT64, False, True)
        assert [g.tolist() for g in stages._flag_deltas(*past)] == list(dc.python_deltas(*past))
        assert ops_torch.launches["flag_deltas"] == before + 2  # in K10's range on the card
    finally:
        engine.use_backend("numpy")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


FR = fr_plain.P_INT


def _fr_limbs(card, ints):
    return torch.from_numpy(fr_plain.to_limbs(ints)).to(card)


@pytest.mark.parametrize("op", [fr_cuda.OP_MUL, fr_cuda.OP_ADD, fr_cuda.OP_SUB], ids=["mul", "add", "sub"])
@pytest.mark.parametrize("n", [1, 31, 200, 16384])  # 200: a full tile of 128 and a short one
def test_fr_mul_kernel_matches_plain_version(card, n, op):
    rng = np.random.default_rng([n, op])
    edges = [(x, y) for x in (0, 1, FR - 1) for y in (0, 1, FR - 1)] if n >= 9 else []
    pairs = [tuple(int.from_bytes(rng.bytes(32), "big") % FR for _ in range(2)) for _ in range(n - len(edges))] + edges
    a, b = _fr_limbs(card, [x for x, _ in pairs]), _fr_limbs(card, [y for _, y in pairs])
    plain = {fr_cuda.OP_MUL: fr_plain.mul, fr_cuda.OP_ADD: fr_plain.add, fr_cuda.OP_SUB: fr_plain.sub}[op]
    before = fr_cuda.launches["fr_mul"]
    got = fr_cuda.fr_mul(a, b, op)
    torch.cuda.synchronize()
    assert fr_cuda.launches["fr_mul"] == before + 1
    assert torch.equal(got.cpu(), plain(a.cpu(), b.cpu()))
    assert torch.equal(fr_cuda.fr_mul(a[:1], b, op).cpu(), plain(a[:1].cpu(), b.cpu()))


@pytest.mark.parametrize("op", [fr_cuda.OP_MUL, fr_cuda.OP_ADD, fr_cuda.OP_SUB], ids=["mul", "add", "sub"])
@pytest.mark.parametrize("offset", [0, 2], ids=["16-byte", "8-byte"])
def test_fr_mul_kernel_on_tensors_of_either_alignment(card, offset, op):
    """K12 copies its tiles in 16-byte pieces where every tensor is
    16-byte aligned and in 8-byte pieces where one is only 8-byte aligned
    (a view two limbs into its storage); 201 rows: a full tile and a short
    one of an odd count of rows."""
    rng = np.random.default_rng([201, op])

    def operand():
        vals = _fr_limbs(card, [int.from_bytes(rng.bytes(32), "big") % FR for _ in range(201)])
        flat = torch.zeros(offset + vals.numel(), dtype=torch.int32, device=card)
        flat[offset:] = vals.view(-1)
        x = flat[offset:].view(201, fr_plain.N_LIMBS)
        assert x.data_ptr() % 16 == 4 * offset and torch.equal(x, vals)
        return x

    a, b = operand(), operand()
    plain = {fr_cuda.OP_MUL: fr_plain.mul, fr_cuda.OP_ADD: fr_plain.add, fr_cuda.OP_SUB: fr_plain.sub}[op]
    assert torch.equal(fr_cuda.fr_mul(a, b, op).cpu(), plain(a.cpu(), b.cpu()))


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
# one pass at 2, 4, 64 and 256; two from 512, the last short at 2,048 (6 + 5
# stages) and 32,768 (8 + 7); three at 2^17 (6 + 6 + 5)
@pytest.mark.parametrize("n, passes", [(2, 1), (4, 1), (64, 1), (1024, 2), (2048, 2), (32768, 2), (1 << 17, 3)])
def test_fr_fft_kernel_matches_plain_version(card, n, passes, inverse):
    rng = np.random.default_rng(n)
    x = fr_plain.to_mont(_fr_limbs(card, [int.from_bytes(rng.bytes(32), "big") % FR for _ in range(n)]))
    before = fr_cuda.launches["fr_fft"]
    got = fr_cuda.fr_fft(x, n, inverse)
    torch.cuda.synchronize()
    assert fr_cuda.launches["fr_fft"] == before + passes == before + fr_cuda.fft_passes(n)  # one launch a pass
    assert torch.equal(got, fr_plain.fft(x, n, inverse))


def test_fr_kernels_take_views_at_any_offset(card):
    """A view that starts one limb into its storage (4-byte aligned only)
    is copied by the wrappers before the kernels' 8-byte accesses."""
    rng = np.random.default_rng(3)
    vals = _fr_limbs(card, [int.from_bytes(rng.bytes(32), "big") % FR for _ in range(64)])
    flat = torch.zeros(1 + vals.numel(), dtype=torch.int32, device=card)
    flat[1:] = vals.view(-1)
    x = flat[1:].view(64, fr_plain.N_LIMBS)
    assert x.data_ptr() % 8 == 4 and torch.equal(x, vals)
    assert torch.equal(fr_cuda.fr_mul(x, x), fr_plain.mul(x.cpu(), x.cpu()).to(card))
    assert torch.equal(fr_cuda.fr_fft(x, 64), fr_plain.fft(x, 64))


def test_fft_entry_points_on_the_card(card):
    rng = np.random.default_rng(5)
    values = [int.from_bytes(rng.bytes(32), "big") % FR for _ in range(256)]
    assert fft_torch.fft_device(values) == host_fr.fft(values)
    assert fft_torch.fft_device(values, inverse=True) == host_fr.fft(values, inv=True)
    assert fft_torch.das_fft_extension_device(values) == host_fr.das_fft_extension(values)


def test_kzg_verifiers_on_the_card(card):
    setup = kzg.insecure_setup(64)
    rng = np.random.default_rng(6)
    coeffs = [harness.random_polynomial(rng, 64) for _ in range(3)] + [[7]]
    rows = [(harness.kzg_commitment(c), *harness.kzg_single_proof(c, 1000 + i)[::-1], 1000 + i)
            for i, c in enumerate(coeffs)]
    cs, ws, ys, xs = (list(v) for v in zip(*rows))
    ys[1] = (ys[1] + 1) % FR
    ws[2] = harness.off_curve_g1_bytes()
    bls_torch.use_device(card)
    before = dict(fq_cuda.launches)
    got = kzg_torch.verify_kzg_proof_batch(cs, ws, xs, ys, setup)
    assert got.tolist() == [True, False, False, True]
    assert got.tolist()[:2] == [kzg.verify_single(c, w, x, y, setup) for c, w, x, y in zip(cs, ws, xs, ys)][:2]
    assert fq_cuda.launches["fq_inv"] == before["fq_inv"] + 1  # one pairing call
