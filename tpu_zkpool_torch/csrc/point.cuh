// Jacobian point formulas for a = 0 curves (BN254 G1 over Fp, G2 over Fp2),
// templated on the field traits of field.cuh and on COMPLETE.
//
// The same formulas, op for op, as tpu_zkpool/msm/grid.py _pdouble (l.236),
// _finish (l.252), _pmadd (l.285) and _padd (l.306). COMPLETE = false is the
// prover mode: the P == Q doubling branch is skipped (P == -Q still gives
// Z3 = 0); identity operands (Z = 0) are always handled. The selects keep
// grid.py's order (doubling, then P == -Q, then P = O, then Q = O), so the
// results equal the plain torch twin limb for limb.
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

template <class F>
__device__ Jac<F> pdouble(const Jac<F>& P) {
  using T = typename F::T;
  T A = F::sqr(P.X);
  T B = F::sqr(P.Y);
  T C = F::sqr(B);
  T xb = F::add(P.X, B);
  T D = F::dbl(F::sub(F::sub(F::sqr(xb), A), C));
  T E = F::add(F::dbl(A), A);
  T Fq = F::sqr(E);
  T X3 = F::sub(Fq, F::dbl(D));
  T C8 = F::dbl(F::dbl(F::dbl(C)));
  T Y3 = F::sub(F::mul(E, F::sub(D, X3)), C8);
  T Z3 = F::dbl(F::mul(P.Y, P.Z));
  return {X3, Y3, Z3};
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
  T Z1Z1 = F::sqr(P.Z);
  T U2 = F::mul(X2, Z1Z1);
  T S2 = F::mul(Y2, F::mul(P.Z, Z1Z1));
  T H = F::sub(U2, P.X);
  T r = F::sub(S2, P.Y);
  T HH = F::sqr(H);
  T HHH = F::mul(H, HH);
  T V = F::mul(P.X, HH);
  T X3 = F::sub(F::sub(F::sqr(r), HHH), F::dbl(V));
  T Y3 = F::sub(F::mul(r, F::sub(V, X3)), F::mul(P.Y, HHH));
  T Z3 = F::mul(P.Z, H);
  Jac<F> Q = {X2, Y2, F::one()};
  return finish<F, COMPLETE, true>(P, Q, {X3, Y3, Z3}, H, r);
}

template <class F, bool COMPLETE>
__device__ Jac<F> padd(const Jac<F>& P, const Jac<F>& Q) {
  using T = typename F::T;
  T Z1Z1 = F::sqr(P.Z);
  T Z2Z2 = F::sqr(Q.Z);
  T U1 = F::mul(P.X, Z2Z2);
  T U2 = F::mul(Q.X, Z1Z1);
  T S1 = F::mul(P.Y, F::mul(Q.Z, Z2Z2));
  T S2 = F::mul(Q.Y, F::mul(P.Z, Z1Z1));
  T H = F::sub(U2, U1);
  T r = F::sub(S2, S1);
  T HH = F::sqr(H);
  T HHH = F::mul(H, HH);
  T V = F::mul(U1, HH);
  T X3 = F::sub(F::sub(F::sqr(r), HHH), F::dbl(V));
  T Y3 = F::sub(F::mul(r, F::sub(V, X3)), F::mul(S1, HHH));
  T Z3 = F::mul(F::mul(P.Z, Q.Z), H);
  return finish<F, COMPLETE, false>(P, Q, {X3, Y3, Z3}, H, r);
}

}  // namespace zk
