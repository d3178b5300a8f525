// BLS12-381 Jacobian point arithmetic on fq.cuh's lane groups: the device
// functions of the static scalar ladders K7 (g1_mul_static) and K8
// (g2_mul_static) of curve.cu. G1 (coordinates in Fq) and G2 (in Fq2) share
// one body, templated on a field adapter, as the F argument does in the
// port's ops/curve_torch.py and the JAX package's ops/curve_jax.py.
//
// The formulas, and the order in which the special cases of the addition
// are resolved, are those of curve_torch.py's jac_double (dbl-2009-l) and
// jac_add (the generic sum, then the doubling, same x with different y,
// infinity on either side). Every field operation returns the canonical
// residue, so the same coordinates as polynomials in the inputs give the
// same Jacobian representative, limb for limb, however they are computed.
// Each formula here is such an identity rewrite of curve_torch.py's (its
// comment gives it), chosen so that the field products form a few levels
// of independent products, each level one batch (fq.cuh's mont_mul_n):
// in Fq2 the doubling 3 levels in place of 16 products one after another,
// the addition 5 in place of 43 and the doubling it always computed.
//
// Like fq.cuh this compiles as plain C++ too, a group's lanes then running
// in lockstep over arrays, so the host test holds the ladders against the
// plain PyTorch version with no read of another lane's entry.
#pragma once

#include "fq.cuh"

namespace curve {

using fq::lanes::kAdd;
using fq::lanes::kinds;
using fq::lanes::Kinds;
using fq::lanes::kSub;
using fq::lanes::Lanes;

// The coordinate field on a group of G lanes: Fq (N = 1) or Fq2 = Fq[u] /
// (u^2 + 1) (N = 2), an element as N halves of D = 16 / G digits a lane,
// held alike by S subgroups of G lanes of a warp. Its products and sums run
// in batches, every call one batch; the products of a batch are split over
// the S subgroups (fq.cuh's mont_mul_split).
template <int G, int N, int S = 1>
struct Field {
  static constexpr int D = fq::lanes::kDigits / G;
  using Digits = Lanes<uint32_t, G>;
  struct E {
    Digits c[N][D];
  };

  // r_j = a_j b_j for the M slots as one batch; slot j is a square where
  // bit j of Squares is set (b_j is then not read). r may alias a or b.
  template <int M, unsigned Squares = 0u>
  FQ_GD static void products(E (&r)[M], const E (&a)[M], const E (&b)[M]) {
    Digits x[M][N][D], y[M][N][D];
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int k = 0; k < D; ++k) {
          x[j][n][k] = a[j].c[n][k];
          y[j][n][k] = (Squares >> j) & 1u ? a[j].c[n][k] : b[j].c[n][k];
        }
    if constexpr (N == 1) {
      Digits z[M][D], xs[M][D], ys[M][D];
#pragma unroll
      for (int j = 0; j < M; ++j)
#pragma unroll
        for (int k = 0; k < D; ++k) xs[j][k] = x[j][0][k], ys[j][k] = y[j][0][k];
      fq::lanes::mont_mul_split<G, S, M>(z, xs, ys);
#pragma unroll
      for (int j = 0; j < M; ++j)
#pragma unroll
        for (int k = 0; k < D; ++k) r[j].c[0][k] = z[j][k];
    } else {
      Digits z[M][2][D];
      fq::lanes::fq2_products<G, M, Squares, S>(z, x, y);
#pragma unroll
      for (int j = 0; j < M; ++j)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int k = 0; k < D; ++k) r[j].c[n][k] = z[j][n][k];
    }
  }

  // each slot's kind of Ops for each of an element's N halves
  FQ_HD static constexpr Kinds halves(Kinds ops, int m) {
    Kinds k = 0;
    for (int j = 0; j < N * m; ++j) k |= (Kinds)fq::lanes::kind(ops, j / N) << (2 * j);
    return k;
  }

  // r_j = a_j op_j b_j for the M slots as one batch, Ops their
  // fq::lanes::Sum kinds (kinds(...)), each half of an Fq2 element alike;
  // r may alias a or b.
  template <int M, Kinds Ops>
  FQ_GD static void sums(E (&r)[M], const E (&a)[M], const E (&b)[M]) {
    Digits x[N * M][D], y[N * M][D], z[N * M][D];
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int k = 0; k < D; ++k) x[N * j + n][k] = a[j].c[n][k], y[N * j + n][k] = b[j].c[n][k];
    fq::lanes::sums<G, N * M, halves(Ops, M)>(z, x, y);
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int k = 0; k < D; ++k) r[j].c[n][k] = z[N * j + n][k];
  }

  // a == 0: every lane ORs its own digits, one ballot joins them; the
  // result is the same on every lane of the group
  FQ_GD static bool is_zero(const E& a) {
    Lanes<bool, G> nonzero;
    FQ_LANES(l, G) {
      uint32_t any = 0;
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int k = 0; k < D; ++k) any |= a.c[n][k][l];
      nonzero[l] = any != 0;
    }
    return fq::lanes::group_ballot<G>(nonzero) == 0;
  }

  // r = m ? a : b, m the same on every lane of the group
  FQ_GD static void select(E& r, bool m, const E& a, const E& b) {
    FQ_LANES(l, G) {
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int k = 0; k < D; ++k) r.c[n][k][l] = m ? a.c[n][k][l] : b.c[n][k][l];
    }
  }

  FQ_GD static void zero(E& r) {
    FQ_LANES(l, G) {
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int k = 0; k < D; ++k) r.c[n][k][l] = 0u;
    }
  }
};

// (X, Y, Z) Jacobian, Z == 0 <=> infinity
template <class F>
struct Jac {
  typename F::E x, y, z;
};

// dbl-2009-l, as curve_torch.py:123-136: A = X^2, B = Y^2, C = B^2,
// D = 2 ((X + B)^2 - A - C), E = 3 A, F = E^2, X3 = F - 2 D,
// Y3 = E (D - X3) - 8 C, Z3 = 2 Y Z; here D = 4 X B and 8 C = 2 (2 B)^2,
// the same polynomials, so that the products fall into 3 levels:
// {A, B, Y Z}, {(2 B)^2, (4 X) B, E^2}, {E (D - X3)}. Z == 0 stays 0. out
// may alias p.
template <class F>
FQ_GD void jac_double(Jac<F>& out, const Jac<F>& p) {
  using E = typename F::E;
  E m1[3];  // A, B, Y Z
  F::template products<3, 0b011u>(m1, {p.x, p.y, p.y}, {p.x, p.y, p.z});
  E s1[4];  // 2 A, Z3 = 2 Y Z, 2 X, 2 B
  F::template sums<4, kinds(kAdd, kAdd, kAdd, kAdd)>(s1, {m1[0], m1[2], p.x, m1[1]}, {m1[0], m1[2], p.x, m1[1]});
  E s2[2];  // E = 3 A, 4 X
  F::template sums<2, kinds(kAdd, kAdd)>(s2, {s1[0], s1[2]}, {m1[0], s1[2]});
  E m2[3];  // 4 C = (2 B)^2, D = (4 X) B, F = E^2
  F::template products<3, 0b101u>(m2, {s1[3], s2[1], s2[0]}, {s1[3], m1[1], s2[0]});
  E s3[2];  // 8 C, 2 D
  F::template sums<2, kinds(kAdd, kAdd)>(s3, {m2[0], m2[1]}, {m2[0], m2[1]});
  E x3[1];  // F - 2 D
  F::template sums<1, kinds(kSub)>(x3, {m2[2]}, {s3[1]});
  E dx[1];  // D - X3
  F::template sums<1, kinds(kSub)>(dx, {m2[1]}, {x3[0]});
  E m3[1];  // E (D - X3)
  F::template products<1>(m3, {s2[0]}, {dx[0]});
  E y3[1];  // E (D - X3) - 8 C
  F::template sums<1, kinds(kSub)>(y3, {m3[0]}, {s3[0]});
  out.x = x3[0];
  out.y = y3[0];
  out.z = s1[1];
}

// The base point of a ladder and what every addition of it reads: Z^2,
// 2 Z^3 and 2 Y, made once for the ladder, and whether it is infinity.
template <class F>
struct Base {
  Jac<F> p;
  typename F::E zz, zzz2, y2;
  bool inf;
};

template <class F>
FQ_GD void prepare(Base<F>& b, const Jac<F>& p) {
  using E = typename F::E;
  b.p = p;
  b.inf = F::is_zero(p.z);
  E zz[1], zzz[1], s[2];
  F::template products<1, 1u>(zz, {p.z}, {p.z});
  F::template products<1>(zzz, {zz[0]}, {p.z});
  F::template sums<2, kinds(kAdd, kAdd)>(s, {zzz[0], p.y}, {zzz[0], p.y});
  b.zz = zz[0];
  b.zzz2 = s[0];
  b.y2 = s[1];
}

// The complete addition P1 + P2 of curve_torch.py:139-174, P2 a ladder's
// base point. Its generic sum: Z1Z1 = Z1^2, Z2Z2 = Z2^2, U1 = X1 Z2Z2,
// U2 = X2 Z1Z1, S1 = Y1 Z2 Z2Z2, S2 = Y2 Z1 Z1Z1, H = U2 - U1,
// r = 2 (S2 - S1), I = (2 H)^2, J = H I, V = U1 I, X3 = r^2 - J - 2 V,
// Y3 = r (V - X3) - 2 S1 J, Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) H; here
// r = 2 S2 - 2 S1 with 2 S1 = Y1 (2 Z2^3) and 2 S2 = (2 Y2) Z1^3, and
// Z3 = (Z1 Z2) (2 H), the same polynomials, in 5 levels of products:
// {Z1Z1, U1, 2 S1, Z1 Z2}, {U2, Z1^3}, {2 S2, I, Z3}, {J, V, r^2},
// {r (V - X3), 2 S1 J}. Then the masked specials in curve_torch.py's
// precedence, each mask the same on every lane of the group (no branch on
// it):
//   1. P1 == P2 (same x, same y): the doubling of P1;
//   2. same x, different y: Z = 0 (P1 == -P2);
//   3. P1 at infinity: P2;
//   4. P2 at infinity: P1.
// The masks are taken on canonical H and r (r is 0 exactly where S2 - S1
// is). The doubling of case 1 is computed only where some group of the
// warp takes it (never, on a subgroup point's ladder). out may alias p1.
template <class F>
FQ_GD void jac_add(Jac<F>& out, const Jac<F>& p1, const Base<F>& q) {
  using E = typename F::E;
  const Jac<F>& p2 = q.p;
  const bool inf1 = F::is_zero(p1.z);
  E m1[4];  // Z1Z1, U1, 2 S1, Z1 Z2
  F::template products<4, 0b0001u>(m1, {p1.z, p1.x, p1.y, p1.z}, {p1.z, q.zz, q.zzz2, p2.z});
  E m2[2];  // U2, Z1^3
  F::template products<2>(m2, {p2.x, m1[0]}, {m1[0], p1.z});
  E h[1];  // H = U2 - U1
  F::template sums<1, kinds(kSub)>(h, {m2[0]}, {m1[1]});
  E h2[1];  // 2 H
  F::template sums<1, kinds(kAdd)>(h2, {h[0]}, {h[0]});
  E m3[3];  // 2 S2, I = (2 H)^2, Z3 = (Z1 Z2) (2 H)
  F::template products<3, 0b010u>(m3, {q.y2, h2[0], m1[3]}, {m2[1], h2[0], h2[0]});
  E r[1];  // r = 2 S2 - 2 S1
  F::template sums<1, kinds(kSub)>(r, {m3[0]}, {m1[2]});
  const bool same_x = F::is_zero(h[0]), same_y = F::is_zero(r[0]);
  E m4[3];  // J = H I, V = U1 I, r^2
  F::template products<3, 0b100u>(m4, {h[0], m1[1], r[0]}, {m3[1], m3[1], r[0]});
  E s4[2];  // r^2 - J, 2 V
  F::template sums<2, kinds(kSub, kAdd)>(s4, {m4[2], m4[1]}, {m4[0], m4[1]});
  E x3[1];  // X3 = r^2 - J - 2 V
  F::template sums<1, kinds(kSub)>(x3, {s4[0]}, {s4[1]});
  E vx[1];  // V - X3
  F::template sums<1, kinds(kSub)>(vx, {m4[1]}, {x3[0]});
  E m5[2];  // r (V - X3), 2 S1 J
  F::template products<2>(m5, {r[0], m1[2]}, {vx[0], m4[0]});
  E y3[1];  // Y3 = r (V - X3) - 2 S1 J
  F::template sums<1, kinds(kSub)>(y3, {m5[0]}, {m5[1]});
  E z3 = m3[2];
  const bool dbl = same_x && same_y;
  if (fq::lanes::warp_any(dbl)) {
    Jac<F> d;
    jac_double<F>(d, p1);
    F::select(x3[0], dbl, d.x, x3[0]);
    F::select(y3[0], dbl, d.y, y3[0]);
    F::select(z3, dbl, d.z, z3);
  }
  E zero;
  F::zero(zero);
  F::select(z3, same_x && !same_y, zero, z3);
  F::select(x3[0], q.inf, p1.x, x3[0]);
  F::select(y3[0], q.inf, p1.y, y3[0]);
  F::select(z3, q.inf, p1.z, z3);
  F::select(out.x, inf1, p2.x, x3[0]);
  F::select(out.y, inf1, p2.y, y3[0]);
  F::select(out.z, inf1, p2.z, z3);
}

// [k] p for a public k > 0 (k.bits its length, the top bit set), as
// curve_torch.py's ladder: from p, for each bit after the leading one, a
// doubling, and an addition of p where the bit is set. The bit is the same
// for every thread, so the branch is uniform.
template <class F>
FQ_GD void mul_static(Jac<F>& r, const Jac<F>& p, const fq::lanes::Exponent& k) {
  Base<F> base;
  prepare<F>(base, p);
  r = p;
  for (int i = k.bits - 2; i >= 0; --i) {
    jac_double<F>(r, r);
    if (fq::lanes::exponent_bit(k, i)) jac_add<F>(r, r, base);
  }
}

}  // namespace curve
