// Jacobian point formulas for a = 0 curves (BN254 G1 over Fp, G2 over Fp2),
// templated on the field traits of field.cuh and on COMPLETE.
//
// The same formulas, op for op, as tpu_zkpool/msm/grid.py _pdouble (l.236),
// _finish (l.252), _pmadd (l.285) and _padd (l.306). COMPLETE = false is the
// prover mode: the P == Q doubling branch is skipped (P == -Q still gives
// Z3 = 0); identity operands (Z = 0) are always handled. The selects keep
// grid.py's order (doubling, then P == -Q, then P = O, then Q = O), so the
// results equal the plain torch twin limb for limb.
//
// Each formula computes its products one dependency level at a time, as
// the twin's ``muls`` groups them (pdouble 3 levels, pmadd and padd 5),
// through level(): on the warp traits (K6) a level's products run on
// separate lanes, on the others one after another. A square is mul(a, a),
// and a Montgomery product is canonical, so neither the order nor the lane
// changes a limb.
#pragma once

#include "field.cuh"

namespace zk {

template <class F>
struct Jac {
  typename F::T X, Y, Z;
};

template <class F>
__device__ __forceinline__ Jac<F> jac_zero() {
  return {F::zero(), F::zero(), F::zero()};
}

// A point row int64[3, NC, 16]: coordinate c at row + c * NC * 16.
template <class F>
__device__ __forceinline__ Jac<F> jac_load(const int64_t* row) {
  constexpr int E = F::NC * 16;
  return {F::load(row), F::load(row + E), F::load(row + 2 * E)};
}

template <class F>
__device__ __forceinline__ void jac_store(int64_t* row, const Jac<F>& P) {
  constexpr int E = F::NC * 16;
  F::store(row, P.X);
  F::store(row + E, P.Y);
  F::store(row + 2 * E, P.Z);
}

// The same rows, two limbs a load or store (row 16-byte aligned).
template <class F>
__device__ __forceinline__ Jac<F> jac_load2(const int64_t* row) {
  constexpr int E = F::NC * 16;
  return {F::load2(row), F::load2(row + E), F::load2(row + 2 * E)};
}

template <class F>
__device__ __forceinline__ void jac_store2(int64_t* row, const Jac<F>& P) {
  constexpr int E = F::NC * 16;
  F::store2(row, P.X);
  F::store2(row + E, P.Y);
  F::store2(row + 2 * E, P.Z);
}

// r[i] = a[i] b[i], i < M: one dependency level's independent products.
template <class F, int M>
__device__ __forceinline__ void level(typename F::T (&r)[M],
                                     const typename F::T (&a)[M],
                                     const typename F::T (&b)[M]) {
  if constexpr (F::kWarp) {
    F::template muls<M>(r, a, b);
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) r[i] = F::mul(a[i], b[i]);
  }
}

template <class F>
__device__ Jac<F> pdouble(const Jac<F>& P) {
  using T = typename F::T;
  T l1[3];  // A = X^2, B = Y^2, Y Z
  level<F, 3>(l1, {P.X, P.Y, P.Y}, {P.X, P.Y, P.Z});
  const T A = l1[0], B = l1[1];
  const T xb = F::add(P.X, B);
  const T E = F::add(F::dbl(A), A);
  T l2[3];  // C = B^2, (X + B)^2, E^2
  level<F, 3>(l2, {B, xb, E}, {B, xb, E});
  const T C = l2[0];
  const T D = F::dbl(F::sub(F::sub(l2[1], A), C));
  const T X3 = F::sub(l2[2], F::dbl(D));
  const T C8 = F::dbl(F::dbl(F::dbl(C)));
  T l3[1];  // E (D - X3)
  level<F, 1>(l3, {E}, {F::sub(D, X3)});
  return {X3, F::sub(l3[0], C8), F::dbl(l1[2])};
}

// _finish: Q is affine (Z2 = 1, never the identity) when QAFF.
template <class F, bool COMPLETE, bool QAFF>
__device__ __forceinline__ Jac<F> finish(const Jac<F>& P, const Jac<F>& Q,
                                         const Jac<F>& R,
                                         const typename F::T& H,
                                         const typename F::T& r) {
  bool p_inf = F::is_zero(P.Z);
  bool q_inf = QAFF ? false : F::is_zero(Q.Z);
  Jac<F> out = R;
  if constexpr (COMPLETE) {
    bool same_x = F::is_zero(H);
    bool finite = !p_inf && !q_inf;
    if (same_x && finite)
      out = F::is_zero(r) ? pdouble<F>(P) : jac_zero<F>();
  }
  if (p_inf) out = Q;
  if (q_inf) out = P;
  return out;
}

template <class F, bool COMPLETE>
__device__ Jac<F> pmadd(const Jac<F>& P, const typename F::T& X2,
                        const typename F::T& Y2) {
  using T = typename F::T;
  T l1[1];  // Z1Z1
  level<F, 1>(l1, {P.Z}, {P.Z});
  T l2[2];  // U2 = X2 Z1Z1, Z1 Z1Z1
  level<F, 2>(l2, {X2, P.Z}, {l1[0], l1[0]});
  const T H = F::sub(l2[0], P.X);
  T l3[3];  // S2 = Y2 Z1^3, HH = H^2, Z3 = Z1 H
  level<F, 3>(l3, {Y2, H, P.Z}, {l2[1], H, H});
  const T r = F::sub(l3[0], P.Y);
  T l4[3];  // HHH = H HH, V = X1 HH, r^2
  level<F, 3>(l4, {H, P.X, r}, {l3[1], l3[1], r});
  const T X3 = F::sub(F::sub(l4[2], l4[0]), F::dbl(l4[1]));
  T l5[2];  // r (V - X3), Y1 HHH
  level<F, 2>(l5, {r, P.Y}, {F::sub(l4[1], X3), l4[0]});
  Jac<F> Q = {X2, Y2, F::one()};
  return finish<F, COMPLETE, true>(P, Q, {X3, F::sub(l5[0], l5[1]), l3[2]},
                                   H, r);
}

template <class F, bool COMPLETE>
__device__ Jac<F> padd(const Jac<F>& P, const Jac<F>& Q) {
  using T = typename F::T;
  T l1[3];  // Z1Z1, Z2Z2, Z1 Z2
  level<F, 3>(l1, {P.Z, Q.Z, P.Z}, {P.Z, Q.Z, Q.Z});
  T l2[4];  // U1 = X1 Z2Z2, U2 = X2 Z1Z1, Z2 Z2Z2, Z1 Z1Z1
  level<F, 4>(l2, {P.X, Q.X, Q.Z, P.Z}, {l1[1], l1[0], l1[1], l1[0]});
  const T H = F::sub(l2[1], l2[0]);
  T l3[4];  // S1 = Y1 Z2^3, S2 = Y2 Z1^3, HH = H^2, Z3 = Z1 Z2 H
  level<F, 4>(l3, {P.Y, Q.Y, H, l1[2]}, {l2[2], l2[3], H, H});
  const T r = F::sub(l3[1], l3[0]);
  T l4[3];  // HHH = H HH, V = U1 HH, r^2
  level<F, 3>(l4, {H, l2[0], r}, {l3[2], l3[2], r});
  const T X3 = F::sub(F::sub(l4[2], l4[0]), F::dbl(l4[1]));
  T l5[2];  // r (V - X3), S1 HHH
  level<F, 2>(l5, {r, l3[0]}, {F::sub(l4[1], X3), l4[0]});
  return finish<F, COMPLETE, false>(P, Q, {X3, F::sub(l5[0], l5[1]), l3[3]},
                                    H, r);
}

}  // namespace zk
