"""BLS12-381 scalar field (Fr) polynomial arithmetic — the host oracle
for the KZG/DAS stack (ref: specs/sharding/beacon-chain.md:92-173
MODULUS/PRIMITIVE_ROOT_OF_UNITY/ROOT_OF_UNITY, specs/das/das-core.md:60-110
fft machinery).

The curve order r has 2-adicity 32: radix-2 FFT domains up to 2^32
elements exist. Host functions use plain Python ints (correctness
reference); the batched device kernels live in ops/fft_torch.py and are
tested bit-identical against these.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

# Curve order of BLS12-381 (the sharding spec's MODULUS,
# sharding/beacon-chain.md:100)
MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# sharding/beacon-chain.md:101
PRIMITIVE_ROOT_OF_UNITY = 7

TWO_ADICITY = 32


def root_of_unity(order: int) -> int:
    """The canonical `order`-th root of unity: PRIMITIVE_ROOT ** ((r-1)/order)
    (sharding/beacon-chain.md ROOT_OF_UNITY construction)."""
    assert order & (order - 1) == 0 and order <= 1 << TWO_ADICITY
    return pow(PRIMITIVE_ROOT_OF_UNITY, (MODULUS - 1) // order, MODULUS)


def roots_of_unity(order: int) -> List[int]:
    """[w^0, w^1, ..., w^(order-1)] for the canonical order-th root w."""
    w = root_of_unity(order)
    out = [1]
    for _ in range(order - 1):
        out.append(out[-1] * w % MODULUS)
    return out


def reverse_bit_order(i: int, order: int) -> int:
    """Bit-reversal of i within log2(order) bits (das-core.md:66-72)."""
    assert order & (order - 1) == 0
    bits = order.bit_length() - 1
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def reverse_bit_order_list(elements: Sequence[int]) -> List[int]:
    """(das-core.md:74-80)"""
    order = len(elements)
    return [elements[reverse_bit_order(i, order)] for i in range(order)]


def fft(values: Sequence[int], inv: bool = False) -> List[int]:
    """Radix-2 DIT FFT over Fr on the canonical domain of size len(values).

    Iterative Cooley-Tukey: bit-reverse the input, then log2(n) butterfly
    stages — the same dataflow the device kernel executes with batched
    limb arithmetic (ops/fft_torch.py)."""
    n = len(values)
    assert n & (n - 1) == 0
    if n == 1:
        return list(values)
    vals = [values[reverse_bit_order(i, n)] % MODULUS for i in range(n)]
    w_n = root_of_unity(n)
    if inv:
        w_n = pow(w_n, MODULUS - 2, MODULUS)
    stage = 2
    while stage <= n:
        w_m = pow(w_n, n // stage, MODULUS)
        half = stage // 2
        for start in range(0, n, stage):
            w = 1
            for j in range(half):
                t = w * vals[start + j + half] % MODULUS
                u = vals[start + j]
                vals[start + j] = (u + t) % MODULUS
                vals[start + j + half] = (u - t) % MODULUS
                w = w * w_m % MODULUS
        stage *= 2
    if inv:
        n_inv = pow(n, MODULUS - 2, MODULUS)
        vals = [v * n_inv % MODULUS for v in vals]
    return vals


def ifft(values: Sequence[int]) -> List[int]:
    return fft(values, inv=True)


def das_fft_extension(data: Sequence[int]) -> List[int]:
    """Given the even-index IFFT inputs, the odd-index inputs such that
    the second half of the IFFT output is zero (das-core.md:90-97)."""
    poly = ifft(data)
    return fft(list(poly) + [0] * len(poly))[1::2]


def extend_data(data: Sequence[int]) -> List[int]:
    """(das-core.md:112-119): reverse-bit-order the input so the first
    half of the extended output IS the original data."""
    rev_bit_odds = reverse_bit_order_list(das_fft_extension(reverse_bit_order_list(data)))
    return list(data) + rev_bit_odds


def unextend_data(extended_data: Sequence[int]) -> List[int]:
    return list(extended_data[: len(extended_data) // 2])


# -- polynomial helpers (coefficient form, ascending powers) -----------------


def poly_eval(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % MODULUS
    return acc


def poly_mul(a: Sequence[int], b: Sequence[int]) -> List[int]:
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            out[i + j] = (out[i + j] + ai * bj) % MODULUS
    return out


def poly_sub(a: Sequence[int], b: Sequence[int]) -> List[int]:
    n = max(len(a), len(b))
    out = [0] * n
    for i in range(n):
        av = a[i] if i < len(a) else 0
        bv = b[i] if i < len(b) else 0
        out[i] = (av - bv) % MODULUS
    return out


def poly_divide(num: Sequence[int], den: Sequence[int]) -> List[int]:
    """Exact polynomial division num / den over Fr (remainder must be 0)."""
    num = [v % MODULUS for v in num]
    den = [v % MODULUS for v in den]
    while den and den[-1] == 0:
        den.pop()
    assert den, "division by zero polynomial"
    out = [0] * (len(num) - len(den) + 1)
    rem = list(num)
    inv_lead = pow(den[-1], MODULUS - 2, MODULUS)
    for i in range(len(out) - 1, -1, -1):
        q = rem[i + len(den) - 1] * inv_lead % MODULUS
        out[i] = q
        for j, d in enumerate(den):
            rem[i + j] = (rem[i + j] - q * d) % MODULUS
    assert all(v == 0 for v in rem), "non-exact polynomial division"
    return out


def interpolate_on_domain(xs: Sequence[int], ys: Sequence[int]) -> List[int]:
    """Lagrange interpolation (small inputs — multiproof verification)."""
    assert len(xs) == len(ys)
    poly = [0]
    for i, (xi, yi) in enumerate(zip(xs, ys)):
        num = [1]
        den = 1
        for j, xj in enumerate(xs):
            if i == j:
                continue
            num = poly_mul(num, [(-xj) % MODULUS, 1])
            den = den * (xi - xj) % MODULUS
        scale = yi * pow(den, MODULUS - 2, MODULUS) % MODULUS
        poly = poly_sub(poly, [(-c * scale) % MODULUS for c in num])
    return poly


def recover_data(data: Sequence[Optional[Sequence[int]]]) -> List[int]:
    """Erasure recovery of subgroup-aligned sample ranges
    (das-core.md:103-110, recover_data — the function body the reference
    leaves as `...`; theory per the referenced Reed-Solomon-with-FFTs
    construction). Returns the full extended data.

    Layout contract (matches reconstruct_extended_data's call shape):
    `data[i]` is sample i's points already reverse-bit-ordered, i.e.
    `data[i][j]` is the evaluation at natural domain index
    `k*j + reverse_bit_order(i, k)` — extended-data sample i occupies the
    multiplicative coset {m : m ≡ rbo(i,k) (mod k)} of the size-n domain.

    Method (zero-polynomial): Z(x) vanishes exactly on the missing
    cosets, so E = D·Z is known everywhere (missing points contribute 0).
    One IFFT interpolates E, a coset-shifted FFT divides out Z where it
    has no zeros, and an FFT returns D's evaluations. Works because the
    extended data IS low-degree (deg D < n/2) and missing cosets cover
    at most half the domain."""
    k = len(data)
    assert k and k & (k - 1) == 0
    assert any(d is not None for d in data), "no samples to recover from"
    sample_len = next(len(d) for d in data if d is not None)
    n = k * sample_len
    missing = [reverse_bit_order(i, k) for i, d in enumerate(data) if d is None]
    if not missing:
        evals = [0] * n
        for i, d in enumerate(data):
            c = reverse_bit_order(i, k)
            for j, v in enumerate(d):
                evals[c + k * j] = v % MODULUS
        return reverse_bit_order_list(evals)
    assert len(missing) * 2 <= k, "need at least half the samples"

    # Z(x) = prod over missing cosets c of (x^sample_len - w^(c*sample_len))
    # — coset {m ≡ c mod k} is exactly the root set of that factor
    w_slen = root_of_unity(k)  # = w_n^sample_len
    z_coeffs = [1]
    for c in missing:
        factor = [0] * (sample_len + 1)
        factor[0] = (-pow(w_slen, c, MODULUS)) % MODULUS
        factor[sample_len] = 1
        z_coeffs = poly_mul(z_coeffs, factor)
    z_coeffs += [0] * (n - len(z_coeffs))

    d_evals = [0] * n
    for i, d in enumerate(data):
        if d is None:
            continue
        c = reverse_bit_order(i, k)
        for j, v in enumerate(d):
            d_evals[c + k * j] = v % MODULUS

    z_evals = fft(z_coeffs)
    e_evals = [d_evals[i] * z_evals[i] % MODULUS for i in range(n)]
    e_coeffs = ifft(e_evals)

    # divide on a coset g·x where Z never vanishes
    g = PRIMITIVE_ROOT_OF_UNITY
    g_pows = [1] * n
    for i in range(1, n):
        g_pows[i] = g_pows[i - 1] * g % MODULUS
    eg = fft([e_coeffs[i] * g_pows[i] % MODULUS for i in range(n)])
    zg = fft([z_coeffs[i] * g_pows[i] % MODULUS for i in range(n)])
    dg = [e * pow(z, MODULUS - 2, MODULUS) % MODULUS for e, z in zip(eg, zg)]
    d_coeffs_g = ifft(dg)
    g_inv = pow(g, MODULUS - 2, MODULUS)
    gi = 1
    d_coeffs = []
    for c in d_coeffs_g:
        d_coeffs.append(c * gi % MODULUS)
        gi = gi * g_inv % MODULUS
    recovered = fft(d_coeffs)
    for i, d in enumerate(data):
        if d is None:
            continue
        c = reverse_bit_order(i, k)
        assert all(
            recovered[c + k * j] == d_evals[c + k * j] for j in range(sample_len)
        ), "recovery disagrees with known samples"
    return reverse_bit_order_list(recovered)
