// The six grid-MSM kernels, K1-K6, for Hopper (sm_90a), each templated on
// the field (FpField for G1, Fp2Field for G2).
//
// Replaces the Pallas kernels of tpu_zkpool/msm/grid.py:
//   K1 msm_prefix_rows  <- _make_prefix_rows_kernel / _prefix_rows_in
//   K2 msm_prefix       <- _make_prefix_kernel / _prefix_tiles
//   K3 msm_wsum         <- _make_wsum_kernel / _wsum_tiles
//   K4 msm_addn         <- _make_addn_kernel / _add_tiles
//   K5 msm_scale_add    <- _make_scale_add_kernel / _scale_add_tile
//   K6 msm_horner       <- _make_horner_kernel / _horner_tiles
//
// Design. The TPU ran each scan as a sequential grid whose steps carried the
// accumulator in VMEM scratch; GPU blocks run in no order and carry nothing,
// so the sequential axis becomes a loop inside one thread and the
// accumulator stays in registers: one thread per lane for K1-K3, one per row
// for K4/K5, a single thread for K6 (W x (c doublings + 1 add), a serial
// tail of ~280 point ops). The (8, 128) lane tiling is not carried over.
//
// Bound (chip_smoke.py computes it for every call): an Fp product is 264
// 32-bit multiply-adds (CIOS), an Fp2 product 3 of them and an Fp2 square
// 2; a point row is 384 B (768 B for G2) of int64 16-bit limbs, four times
// its packed size. At that layout the two kernels that read each row once
// for one formula over Fp, K1 (a mixed add per row) and K4 (a general add),
// are bound by bytes; K2 and K3 (scans), K5 and K6 (doubling chains) and
// every kernel over Fp2 are bound by operations. Packed 8 x 32-bit storage
// would quarter the bytes and leave all of them bound by operations. With
// one thread per lane these first kernels fill at most `lanes` threads
// (1,024 on the MSM's path), far below the card's occupancy, so they run
// far above either bound; more lanes per SM, packed storage and inlined
// products are later work.
//
// Interface: plain C, int64 16-bit-limb rows as the torch wrappers hold them
// (tpu_zkpool_torch/msm/kernels.py), launched on the caller's stream; each
// launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "point.cuh"

namespace zk {

constexpr int kBlock = 128;

__host__ __device__ constexpr int elems(int nc) { return nc * 16; }

// K1: per-lane inclusive prefix of mixed adds over k steps of gathered
// affine rows (k, lanes, 2, NC, 16), Y negated where signs != 0.
template <class F, bool COMPLETE>
__global__ void k_prefix_rows(const int64_t* __restrict__ rows,
                              const int64_t* __restrict__ signs,
                              int64_t* __restrict__ out, int k, int lanes) {
  constexpr int E = elems(F::NC);
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Jac<F> acc = jac_zero<F>();
  for (int j = 0; j < k; ++j) {
    size_t i = (size_t)j * lanes + l;
    const int64_t* q = rows + i * 2 * E;
    typename F::T x = F::load(q);
    typename F::T y = F::load(q + E);
    if (signs[i] != 0) y = F::sub(F::zero(), y);
    acc = pmadd<F, COMPLETE>(acc, x, y);
    jac_store<F>(out + i * 3 * E, acc);
  }
}

// K2: per-lane inclusive prefix over k steps of (k, lanes, C, NC, 16); C = 2
// (affine, mixed adds) or 3 (Jacobian, general adds).
template <class F, bool MIXED, bool COMPLETE>
__global__ void k_prefix(const int64_t* __restrict__ in,
                         int64_t* __restrict__ out, int k, int lanes) {
  constexpr int E = elems(F::NC);
  constexpr int C = MIXED ? 2 : 3;
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Jac<F> acc = jac_zero<F>();
  for (int j = 0; j < k; ++j) {
    size_t i = (size_t)j * lanes + l;
    const int64_t* q = in + i * C * E;
    if constexpr (MIXED)
      acc = pmadd<F, COMPLETE>(acc, F::load(q), F::load(q + E));
    else
      acc = padd<F, COMPLETE>(acc, jac_load<F>(q));
    jac_store<F>(out + i * 3 * E, acc);
  }
}

// K3: weighted suffix sum over L steps of (L, lanes, 3, NC, 16), fed from
// step L-1 down to 0: acc = sum B_l, tot = sum (l + 1) B_l. Always complete
// (an empty bucket makes tot meet acc).
template <class F>
__global__ void k_wsum(const int64_t* __restrict__ in,
                       int64_t* __restrict__ out, int L, int lanes) {
  constexpr int E = elems(F::NC);
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  Jac<F> acc = jac_zero<F>(), tot = jac_zero<F>();
  for (int j = L - 1; j >= 0; --j) {
    acc = padd<F, true>(acc, jac_load<F>(in + ((size_t)j * lanes + l) * 3 * E));
    tot = padd<F, true>(tot, acc);
  }
  jac_store<F>(out + (size_t)l * 3 * E, acc);
  jac_store<F>(out + ((size_t)lanes + l) * 3 * E, tot);
}

// K4: row-parallel complete a + b.
template <class F>
__global__ void k_addn(const int64_t* __restrict__ a,
                       const int64_t* __restrict__ b,
                       int64_t* __restrict__ out, int n) {
  constexpr int E = elems(F::NC);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t o = (size_t)i * 3 * E;
  jac_store<F>(out + o, padd<F, true>(jac_load<F>(a + o), jac_load<F>(b + o)));
}

// K5: row-parallel 2^s a + b (s doublings, then one complete add).
template <class F>
__global__ void k_scale_add(const int64_t* __restrict__ a,
                            const int64_t* __restrict__ b,
                            int64_t* __restrict__ out, int n, int s) {
  constexpr int E = elems(F::NC);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t o = (size_t)i * 3 * E;
  Jac<F> P = jac_load<F>(a + o);
  for (int t = 0; t < s; ++t) P = pdouble<F>(P);
  jac_store<F>(out + o, padd<F, true>(P, jac_load<F>(b + o)));
}

// K6: Horner sum_w 2^(c w) S_w over (W, 3, NC, 16), one thread.
template <class F>
__global__ void k_horner(const int64_t* __restrict__ S,
                         int64_t* __restrict__ out, int W, int c) {
  constexpr int E = elems(F::NC);
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  Jac<F> acc = jac_zero<F>();
  for (int t = W - 1; t >= 0; --t) {
    for (int d = 0; d < c; ++d) acc = pdouble<F>(acc);
    acc = padd<F, true>(acc, jac_load<F>(S + (size_t)t * 3 * E));
  }
  jac_store<F>(out, acc);
}

inline dim3 grid_for(int n) { return dim3((n + kBlock - 1) / kBlock); }

}  // namespace zk

using zk::Fp2Field;
using zk::FpField;

extern "C" {

int msm_prefix_rows(const int64_t* rows, const int64_t* signs, int64_t* out,
                    int k, int lanes, int ncomp, int complete, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g = zk::grid_for(lanes);
  if (ncomp == 1 && complete)
    zk::k_prefix_rows<FpField, true><<<g, zk::kBlock, 0, s>>>(rows, signs, out, k, lanes);
  else if (ncomp == 1)
    zk::k_prefix_rows<FpField, false><<<g, zk::kBlock, 0, s>>>(rows, signs, out, k, lanes);
  else if (complete)
    zk::k_prefix_rows<Fp2Field, true><<<g, zk::kBlock, 0, s>>>(rows, signs, out, k, lanes);
  else
    zk::k_prefix_rows<Fp2Field, false><<<g, zk::kBlock, 0, s>>>(rows, signs, out, k, lanes);
  return (int)cudaGetLastError();
}

// mixed: complete or not; Jacobian: complete only (the wrapper checks).
int msm_prefix(const int64_t* in, int64_t* out, int k, int lanes, int ncomp,
               int mixed, int complete, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g = zk::grid_for(lanes);
  if (ncomp == 1) {
    if (mixed && complete)
      zk::k_prefix<FpField, true, true><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes);
    else if (mixed)
      zk::k_prefix<FpField, true, false><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes);
    else
      zk::k_prefix<FpField, false, true><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes);
  } else {
    if (mixed && complete)
      zk::k_prefix<Fp2Field, true, true><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes);
    else if (mixed)
      zk::k_prefix<Fp2Field, true, false><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes);
    else
      zk::k_prefix<Fp2Field, false, true><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes);
  }
  return (int)cudaGetLastError();
}

int msm_wsum(const int64_t* in, int64_t* out, int L, int lanes, int ncomp,
             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g = zk::grid_for(lanes);
  if (ncomp == 1)
    zk::k_wsum<FpField><<<g, zk::kBlock, 0, s>>>(in, out, L, lanes);
  else
    zk::k_wsum<Fp2Field><<<g, zk::kBlock, 0, s>>>(in, out, L, lanes);
  return (int)cudaGetLastError();
}

int msm_addn(const int64_t* a, const int64_t* b, int64_t* out, int n,
             int ncomp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g = zk::grid_for(n);
  if (ncomp == 1)
    zk::k_addn<FpField><<<g, zk::kBlock, 0, s>>>(a, b, out, n);
  else
    zk::k_addn<Fp2Field><<<g, zk::kBlock, 0, s>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

int msm_scale_add(const int64_t* a, const int64_t* b, int64_t* out, int n,
                  int ncomp, int log2s, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g = zk::grid_for(n);
  if (ncomp == 1)
    zk::k_scale_add<FpField><<<g, zk::kBlock, 0, s>>>(a, b, out, n, log2s);
  else
    zk::k_scale_add<Fp2Field><<<g, zk::kBlock, 0, s>>>(a, b, out, n, log2s);
  return (int)cudaGetLastError();
}

int msm_horner(const int64_t* S, int64_t* out, int W, int ncomp, int c,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ncomp == 1)
    zk::k_horner<FpField><<<1, 1, 0, s>>>(S, out, W, c);
  else
    zk::k_horner<Fp2Field><<<1, 1, 0, s>>>(S, out, W, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
