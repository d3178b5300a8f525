// BLS12-381 Jacobian point arithmetic on fq.cuh's lane groups: the device
// functions of the static scalar ladders K7 (g1_mul_static) and K8
// (g2_mul_static) of curve.cu. G1 (coordinates in Fq) and G2 (in Fq2) share
// one body, templated on a field adapter, as the F argument does in the
// port's ops/curve_torch.py and the JAX package's ops/curve_jax.py.
//
// The formulas, and the order in which the special cases of the addition
// are resolved, are those of curve_torch.py's jac_double (dbl-2009-l) and
// jac_add (the generic sum, then the doubling, same x with different y,
// infinity on either side): every field operation returns the canonical
// residue, so the same formulas give the same Jacobian representative, limb
// for limb, however each one's field operations are ordered.
//
// Like fq.cuh this compiles as plain C++ too, a group's lanes then running
// in lockstep over arrays, so the host test holds the ladders against the
// plain PyTorch version with no read of another lane's entry.
#pragma once

#include "fq.cuh"

namespace curve {

using fq::lanes::Lanes;

// The coordinate field on a group of G lanes: Fq (N = 1) or Fq2 = Fq[u] /
// (u^2 + 1) (N = 2), an element as N halves of D = 16 / G digits a lane.
template <int G, int N>
struct Field {
  static constexpr int D = fq::lanes::kDigits / G;
  struct E {
    Lanes<uint32_t, G> c[N][D];
  };

  FQ_GD static void mul(E& r, const E& a, const E& b) {
    if constexpr (N == 1) {
      fq::lanes::mont_mul<G>(r.c[0], a.c[0], b.c[0]);
    } else {
      fq::lanes::fq2_mul<G>(r.c, a.c, b.c);
    }
  }

  FQ_GD static void square(E& r, const E& a) {
    if constexpr (N == 1) {
      fq::lanes::mont_mul<G>(r.c[0], a.c[0], a.c[0]);
    } else {
      fq::lanes::fq2_square<G>(r.c, a.c);
    }
  }

  FQ_GD static void add(E& r, const E& a, const E& b) {
#pragma unroll
    for (int n = 0; n < N; ++n) fq::lanes::addsub<G>(r.c[n], a.c[n], b.c[n], 0);
  }

  FQ_GD static void sub(E& r, const E& a, const E& b) {
#pragma unroll
    for (int n = 0; n < N; ++n) fq::lanes::addsub<G>(r.c[n], a.c[n], b.c[n], 1);
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

// dbl-2009-l, as curve_torch.py:123-136. Z == 0 stays 0. out may alias p.
template <class F>
FQ_GD void jac_double(Jac<F>& out, const Jac<F>& p) {
  typename F::E a, b, c, d, e, t, x3, y3, z3;
  F::square(a, p.x);
  F::square(b, p.y);
  F::square(c, b);
  F::add(t, p.x, b);
  F::square(t, t);
  F::sub(t, t, a);
  F::sub(t, t, c);
  F::add(d, t, t);  // d = 2 ((x + b)^2 - a - c)
  F::add(e, a, a);
  F::add(e, e, a);  // e = 3 a
  F::square(t, e);  // f = e^2
  F::add(x3, d, d);
  F::sub(x3, t, x3);  // x3 = f - 2 d
  F::sub(t, d, x3);
  F::mul(y3, e, t);
  F::add(c, c, c);
  F::add(c, c, c);
  F::add(c, c, c);  // 8 c
  F::sub(y3, y3, c);  // y3 = e (d - x3) - 8 c
  F::mul(z3, p.y, p.z);
  F::add(z3, z3, z3);  // z3 = 2 y z
  out.x = x3;
  out.y = y3;
  out.z = z3;
}

// The complete addition of curve_torch.py:139-174: the generic sum, then
// the masked specials in its precedence, each mask the same on every lane
// of the group (no branch):
//   1. P1 == P2 (same x, same y): the doubling of P1;
//   2. same x, different y: Z = 0 (P1 == -P2);
//   3. P1 at infinity: P2;
//   4. P2 at infinity: P1.
// out may alias p1 or p2.
template <class F>
FQ_GD void jac_add(Jac<F>& out, const Jac<F>& p1, const Jac<F>& p2) {
  typename F::E z1z1, z2z2, u1, u2, s1, s2, h, r, i, j, v, t, x3, y3, z3;
  const bool inf1 = F::is_zero(p1.z), inf2 = F::is_zero(p2.z);
  F::square(z1z1, p1.z);
  F::square(z2z2, p2.z);
  F::mul(u1, p1.x, z2z2);
  F::mul(u2, p2.x, z1z1);
  F::mul(t, z2z2, p2.z);
  F::mul(s1, p1.y, t);
  F::mul(t, z1z1, p1.z);
  F::mul(s2, p2.y, t);
  F::sub(h, u2, u1);
  F::sub(t, s2, s1);
  const bool same_x = F::is_zero(h), same_y = F::is_zero(t);
  F::add(r, t, t);  // r = 2 (s2 - s1)
  F::add(t, h, h);
  F::square(i, t);  // i = (2 h)^2
  F::mul(j, h, i);
  F::mul(v, u1, i);
  F::square(x3, r);
  F::add(t, v, v);
  F::add(t, j, t);
  F::sub(x3, x3, t);  // x3 = r^2 - (j + 2 v)
  F::sub(t, v, x3);
  F::mul(y3, r, t);
  F::mul(t, s1, j);
  F::add(t, t, t);
  F::sub(y3, y3, t);  // y3 = r (v - x3) - 2 s1 j
  F::add(t, p1.z, p2.z);
  F::square(t, t);
  F::sub(t, t, z1z1);
  F::sub(t, t, z2z2);
  F::mul(z3, t, h);  // z3 = ((z1 + z2)^2 - z1z1 - z2z2) h
  Jac<F> d;
  jac_double<F>(d, p1);
  const bool dbl = same_x && same_y;
  F::select(x3, dbl, d.x, x3);
  F::select(y3, dbl, d.y, y3);
  F::select(z3, dbl, d.z, z3);
  typename F::E zero;
  F::zero(zero);
  F::select(z3, same_x && !same_y, zero, z3);
  F::select(x3, inf2, p1.x, x3);
  F::select(y3, inf2, p1.y, y3);
  F::select(z3, inf2, p1.z, z3);
  F::select(out.x, inf1, p2.x, x3);
  F::select(out.y, inf1, p2.y, y3);
  F::select(out.z, inf1, p2.z, z3);
}

// [k] p for a public k > 0 (k.bits its length, the top bit set), as
// curve_torch.py's ladder: from p, for each bit after the leading one, a
// doubling, and an addition of p where the bit is set. The bit is the same
// for every thread, so the branch is uniform.
template <class F>
FQ_GD void mul_static(Jac<F>& r, const Jac<F>& p, const fq::lanes::Exponent& k) {
  r = p;
  for (int i = k.bits - 2; i >= 0; --i) {
    jac_double<F>(r, r);
    if (fq::lanes::exponent_bit(k, i)) jac_add<F>(r, r, p);
  }
}

}  // namespace curve
