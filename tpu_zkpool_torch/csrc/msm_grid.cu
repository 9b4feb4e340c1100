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
// so a sequential axis becomes a loop inside a thread and the accumulator
// stays in registers. The (8, 128) lane tiling is not carried over.
//
// Bound (chip_smoke.py computes it for every call): an Fp product is 264
// 32-bit multiply-adds (CIOS), an Fp2 product 3 of them and an Fp2 square
// 2; a point row is 384 B (768 B for G2) of int64 16-bit limbs, four times
// its packed size. K4 over Fp is bound by bytes; every other kernel, and
// every kernel over Fp2, by operations. What holds them far above either
// bound is latency: a point add is ~16 dependent out-of-line products, so a
// thread that walks a chain of n adds takes n times one add's latency
// (~13 us over Fp with a warp or two a scheduler), and a launch with fewer
// warps than the card holds leaves it idle. So each design cuts the longest
// chain of dependent adds and fills the SMs with independent warps.
//
// K1 (k_prefix_rows): one thread per (window, lane), every window of a
// slice in one launch (20 x 1,024 threads on the prover's path, where one
// launch a window gave 1,024). Each thread walks its lane's k steps in
// order, as the TPU did (the association, and so every limb, is the
// JAX prefix_signed's), loading its own rows from the affine source by the
// payload's index and negating Y by its sign bit: no gathered copy of the
// rows is made. It writes the prefix in sorted order (row l * k + j of
// window w), so the boundary gathers index it directly. Chain: k mixed
// adds. Bound: operations (one mixed add a row), then the output's bytes.
//
// K3 (k_wsum): one warp per lane. The L steps split into T = min(L, 32)
// segments of s (a power of two, steps past L are identities); thread t
// runs its segment serially from the top (a = a + B, w = w + a), a
// Kogge-Stone scan over the warp's shuffles gives the suffix sums S_t, each
// thread adds 2^log2s S_t to w_t, and a shuffle tree sums the w_t into
// tot. Chain at L = 128: 8 + 5 + 2 + 1 + 5 = 21 dependent adds or
// doublings, where one thread per lane walked 256, on 640 warps where 640
// threads ran. The total work roughly doubles; the card has room for it.
// Every add is complete: empty buckets are the identity and equal or
// opposite partial sums occur. The schedule (T, log2 s) comes from the
// wrapper (grid.wsum_schedule), which the plain twin follows add for add.
//
// K2 (k_prefix): one warp per lane, K3's split. The k steps form T = min(k,
// 32) segments of s (grid.prefix_schedule); thread t writes its segment's
// inclusive prefix serially (its first step taken as is: the add from the
// identity changes no limb but for an identity input, which becomes O), a
// Kogge-Stone scan over the warp's shuffles gives the inclusive segment
// totals, and thread t >= 1 adds the total of segment t - 1 into its s
// outputs. Chain at k = 32: 0 + 5 + 1 = 6 adds, where one thread per lane
// walked 32; only the real lanes are launched (640 and 20 warps on the
// prover's path, where 1,024 threads ran twice). `mixed` selects affine
// input and mixed segment adds, `complete` the segment adds' doubling
// branch; the scan and carry adds are complete always (equal and opposite
// partial sums occur).
//
// K6 (k_horner): one warp, design (B) of the two weighed. Horner's chain is
// inherently serial (any addition chain for 2^(c (W - 1)) needs c (W - 1)
// doublings in sequence), so only each op's time can shrink. The product
// microbenchmark (chip_smoke.py, phase 2) decides how: one thread's product
// is bound by the issue of its multiply-adds, not by its carry chain's
// latency (three products interleaved in one thread took 2.8-3.7 times
// one), so (A), one thread issuing a level's products together, gains
// nothing; and inlining the product into the formulas outgrew the
// instruction cache. A warp instruction costs the same with one lane active
// or 32, so (B) gives each of a level's independent products its own lane
// (lane i product i; over Fp2 lane 3 i + c Karatsuba product c of pair i,
// up to 12 lanes), one out-of-line product a level, and shuffles hand every
// lane every result (field.cuh FpWarp / Fp2Warp through point.cuh's
// level()): a doubling costs 3 product times, an add 5, where one thread paid
// 7 and 16 (21 and 48 over Fp2). Every lane holds the same values, so every
// branch is uniform; lane 0 stores. The c doublings of the top window are
// skipped (acc is still the literal identity, and pdouble(0, 0, 0) = (0,
// 0, 0)); nothing after the first add is skipped, since an identity S_w
// may carry nonzero X and Y. Chain at W = 20, c = 13: 19 x 13 doublings
// and 20 adds, 841 product levels.
//
// K4 (k_addn): a throughput kernel, one thread a row: its calls hold 20
// to 81,960 independent complete adds, far more than the 132 SMs run at
// once, so the work per SM, not a chain, sets its time. Two things cut it.
// (1) It gathers its own operands: A(i) = a[ia[i]], B(i) = b[ib[i]] (an
// index < 0 a row of zeros), B's Y negated where asked, a row zeroed by a
// mask: the grid pipeline's boundary gathers, selects and Y negations are
// the kernel's loads, not torch passes over full int64 point rows (384 B a
// G1 row, 768 B a G2 row) before each call, and a zeroed row loads
// nothing. (2) Rows move two limbs a 16-byte load or store
// (jac_load2), and the launch shape (AddnShape) was chosen by measurement:
// one-warp blocks, 12 a SM, fp_mul over Fp and the PTX product over Fp2.
// Bound: over Fp the bytes, over Fp2 the operations (chip_smoke.py computes
// both for every call). The complete add is padd<F, true>, so every limb
// is the twin's.
//
// K5 (k_scale_add): 2^s a + b over the W window rows, a chain of s
// doublings and one add a row and nothing to fill the card with, so K6's
// design: one warp a row on the warp traits (FpWarp, Fp2Warp), a level's
// products on its lanes, a block a row so that each chain has its own SM.
// Chain at s = 7: 7 x 3 + 5 = 26 product levels, where one thread paid 65
// products.
//
// K2, K5, K6 and K4 over Fp2 run fp_mul_fast (field.cuh), the out-of-line
// product of PTX carry chains; packed 32-bit storage between the kernels is
// later work.
//
// Interface: plain C, int64 16-bit-limb rows as the torch wrappers hold them
// (tpu_zkpool_torch/msm/kernels.py; K4's indices int64, its mask bool),
// launched on the caller's stream; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "point.cuh"

namespace zk {

constexpr int kBlock = 128;
constexpr int kWarp = 32;

__host__ __device__ constexpr int elems(int nc) { return nc * 16; }

// K1: per (window, lane) inclusive prefix of mixed adds over k steps. xy
// (N, 2, NC, 16) affine source rows; payload (W, k, lanes), index | neg <<
// 31, Y negated where neg is set; out (W, k * lanes, 3, NC, 16) in sorted
// order: row l * k + j of window w holds step j of lane l.
template <class F, bool COMPLETE>
__global__ void __launch_bounds__(kBlock)
    k_prefix_rows(const int64_t* __restrict__ xy,
                  const int64_t* __restrict__ payload,
                  int64_t* __restrict__ out, int W, int k, int lanes) {
  constexpr int E = elems(F::NC);
  int g = blockIdx.x * blockDim.x + threadIdx.x;  // w * lanes + l
  if (g >= W * lanes) return;
  int w = g / lanes, l = g - w * lanes;
  const int64_t* pw = payload + (size_t)w * k * lanes + l;
  int64_t* ow = out + ((size_t)w * k * lanes + (size_t)l * k) * 3 * E;
  Jac<F> acc = jac_zero<F>();
  for (int j = 0; j < k; ++j) {
    int64_t p = pw[(size_t)j * lanes];
    const int64_t* q = xy + (size_t)(p & 0x7FFFFFFF) * 2 * E;
    typename F::T x = F::load(q);
    typename F::T y = F::load(q + E);
    if (p >> 31) y = F::sub(F::zero(), y);
    acc = pmadd<F, COMPLETE>(acc, x, y);
    jac_store<F>(ow + (size_t)j * 3 * E, acc);
  }
}

// Point P of the thread d lanes down the warp (every thread of the warp
// calls it; the value is P's own where t < d, and unused there).
template <class F>
__device__ __forceinline__ Jac<F> shfl_up(Jac<F> P, int d) {
  constexpr int NW = sizeof(Jac<F>) / sizeof(uint32_t);
  uint32_t* w = reinterpret_cast<uint32_t*>(&P);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = __shfl_up_sync(0xffffffffu, w[i], d);
  return P;
}

// K2's complete adds, one out-of-line copy for its three call sites (three
// inlined copies doubled msm_grid.cu's build time and spilled over Fp2).
template <class F>
__device__ __noinline__ Jac<F> padd_call(const Jac<F> P, const Jac<F> Q) {
  return padd<F, true>(P, Q);
}

// K2: per-lane inclusive prefix over k steps of (k, lanes, C, NC, 16); C = 2
// (affine, mixed segment adds) or 3 (Jacobian, general adds); one warp per
// lane on the schedule (T, log2s) of grid.prefix_schedule (design note).
template <class F, bool MIXED, bool COMPLETE>
__global__ void __launch_bounds__(kBlock)
    k_prefix(const int64_t* __restrict__ in, int64_t* __restrict__ out, int k,
             int lanes, int T, int log2s) {
  constexpr int E = elems(F::NC);
  constexpr int C = MIXED ? 2 : 3;
  const int t = threadIdx.x % kWarp;
  const int l = blockIdx.x * (kBlock / kWarp) + threadIdx.x / kWarp;
  if (l >= lanes) return;  // the whole warp
  const int s = 1 << log2s;
  // 1. segment t, steps t s .. min(t s + s, k) - 1: its inclusive prefix
  // into out (a segment past k is empty and its total the identity)
  const int j0 = t * s, j1 = min(j0 + s, k);
  Jac<F> a = jac_zero<F>();
  for (int j = j0; j < j1; ++j) {
    const size_t i = (size_t)j * lanes + l;
    const int64_t* q = in + i * C * E;
    if constexpr (MIXED) {
      typename F::T x = F::load(q), y = F::load(q + E);
      a = j == j0 ? Jac<F>{x, y, F::one()} : pmadd<F, COMPLETE>(a, x, y);
    } else {
      Jac<F> Q = jac_load<F>(q);
      if (j > j0)
        a = padd_call<F>(a, Q);
      else if (!F::is_zero(Q.Z))  // O + Q: an identity Q becomes O
        a = Q;
    }
    jac_store<F>(out + i * 3 * E, a);
  }
  // 2. inclusive scan of the segment totals over the T threads
  for (int d = 1; d < T; d <<= 1) {
    Jac<F> o = shfl_up<F>(a, d);
    if (t >= d && t < T) a = padd_call<F>(o, a);
  }
  // 3. the total of segments 0 .. t - 1 into this segment's outputs
  Jac<F> cy = shfl_up<F>(a, 1);
  if (t >= 1 && t < T) {
    for (int j = j0; j < j1; ++j) {
      int64_t* o = out + ((size_t)j * lanes + l) * 3 * E;
      jac_store<F>(o, padd_call<F>(cy, jac_load<F>(o)));
    }
  }
}

// Point P of the thread d lanes up the warp (every thread of the warp
// calls it; the value is P's own where t + d >= 32, and unused there).
template <class F>
__device__ __forceinline__ Jac<F> shfl_down(Jac<F> P, int d) {
  constexpr int NW = sizeof(Jac<F>) / sizeof(uint32_t);
  uint32_t* w = reinterpret_cast<uint32_t*>(&P);
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = __shfl_down_sync(0xffffffffu, w[i], d);
  return P;
}

// K3: weighted suffix sum over L steps of (L, lanes, 3, NC, 16): acc = sum
// B_l, tot = sum (l + 1) B_l, one warp per lane on the schedule (T, log2s)
// of grid.wsum_schedule (design note above). Always complete (an empty
// bucket makes w meet a).
template <class F>
__global__ void __launch_bounds__(kBlock)
    k_wsum(const int64_t* __restrict__ in, int64_t* __restrict__ out, int L,
           int lanes, int T, int log2s) {
  constexpr int E = elems(F::NC);
  const int t = threadIdx.x % kWarp;
  const int l = blockIdx.x * (kBlock / kWarp) + threadIdx.x / kWarp;
  if (l >= lanes) return;  // the whole warp
  const int s = 1 << log2s;
  // 1. this thread's segment, steps t s .. t s + s - 1, from the top down
  Jac<F> a = jac_zero<F>(), w = jac_zero<F>();
  if (t < T) {
    for (int j = s - 1; j >= 0; --j) {
      int st = t * s + j;
      if (st >= L) continue;  // padding: a is still O, so w stays O
      a = padd<F, true>(a, jac_load<F>(in + ((size_t)st * lanes + l) * 3 * E));
      w = padd<F, true>(w, a);
    }
  }
  // 2. inclusive suffix scan of a over the T threads: a_0 = acc
  for (int d = 1; d < T; d <<= 1) {
    Jac<F> o = shfl_down<F>(a, d);
    if (t + d < T) a = padd<F, true>(a, o);
  }
  // 3. x = w + 2^log2s S, S = the exclusive suffix a_(t+1)
  Jac<F> S = shfl_down<F>(a, 1);
  if (t + 1 >= T) S = jac_zero<F>();
  for (int i = 0; i < log2s; ++i) S = pdouble<F>(S);
  Jac<F> x = padd<F, true>(w, S);
  // 4. tree sum of x over the T threads into thread 0
  for (int d = 1; d < T; d <<= 1) {
    Jac<F> o = shfl_down<F>(x, d);
    if (t % (2 * d) == 0 && t + d < T) x = padd<F, true>(x, o);
  }
  if (t == 0) {
    jac_store<F>(out + (size_t)l * 3 * E, a);
    jac_store<F>(out + ((size_t)lanes + l) * 3 * E, x);
  }
}

// K4: row-parallel complete A(i) + B(i) (design note). A(i) = a[ia[i]]
// (ia null: a[i]; an index < 0: a row of zeros), B(i) likewise from b and
// ib with Y -> p - Y where neg_b; row i of out is zeros where zero[i]
// (zero null: nowhere). An index past its source's rows traps.
template <class F>
__device__ __forceinline__ Jac<F> addn_operand(const int64_t* __restrict__ src,
                                               const int64_t* __restrict__ idx,
                                               int i, int64_t n_src) {
  const int64_t r = idx != nullptr ? idx[i] : i;
  if (r < 0) return jac_zero<F>();
  if (r >= n_src) __trap();
  return jac_load2<F>(src + (size_t)r * 3 * elems(F::NC));
}

// K4's launch shape a field, from scripts/k4_sweep.py on the H100 (PERF.md
// §6): the product, the block and the blocks an SM must hold, which caps
// the registers at 65,536 / (block x blocks). One warp a block spreads the
// last wave's rows over every SM; 12 warps an SM beat 16 with a 128-register
// cap (spills) and 8 at 255 registers.
template <int NC>
struct AddnShape;
template <>
struct AddnShape<1> {
  using F = FpField;  // fp_mul: 5-7% faster here than the PTX product
  static constexpr int kBlock = 32, kMin = 12;  // 160 registers
};
template <>
struct AddnShape<2> {
  using F = Fp2FieldFast;  // the PTX product: 2-4% faster over Fp2
  static constexpr int kBlock = 32, kMin = 12;  // 168 registers, spills
};

template <class F, int BLOCK, int MINB>
__global__ void __launch_bounds__(BLOCK, MINB)
    k_addn(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
           const int64_t* __restrict__ ia, const int64_t* __restrict__ ib,
           const uint8_t* __restrict__ zero, int64_t* __restrict__ out, int n,
           int64_t na, int64_t nb, int neg_b) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  int64_t* o = out + (size_t)i * 3 * elems(F::NC);
  if (zero != nullptr && zero[i]) {
    jac_store2<F>(o, jac_zero<F>());
    return;
  }
  const Jac<F> P = addn_operand<F>(a, ia, i, na);
  Jac<F> Q = addn_operand<F>(b, ib, i, nb);
  if (neg_b) Q.Y = F::sub(F::zero(), Q.Y);
  jac_store2<F>(o, padd<F, true>(P, Q));
}

// K5: 2^s a + b for row blockIdx.x (s doublings, then one complete add), one
// warp on the warp traits (design note); lane 0 stores.
template <class F>
__global__ void __launch_bounds__(kWarp)
    k_scale_add(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out, int s) {
  const size_t o = (size_t)blockIdx.x * 3 * elems(F::NC);
  Jac<F> P = jac_load<F>(a + o);
  for (int t = 0; t < s; ++t) P = pdouble<F>(P);
  P = padd<F, true>(P, jac_load<F>(b + o));
  if (threadIdx.x == 0) jac_store<F>(out + o, P);
}

// K6: Horner sum_w 2^(c w) S_w over (W, 3, NC, 16), one warp on the warp
// traits (design note): from the top window down, c doublings (none at the
// top), then one complete add; lane 0 stores.
template <class F>
__global__ void __launch_bounds__(kWarp)
    k_horner(const int64_t* __restrict__ S, int64_t* __restrict__ out, int W,
             int c) {
  constexpr int E = elems(F::NC);
  Jac<F> acc =
      padd<F, true>(jac_zero<F>(), jac_load<F>(S + (size_t)(W - 1) * 3 * E));
  for (int t = W - 2; t >= 0; --t) {
    for (int d = 0; d < c; ++d) acc = pdouble<F>(acc);
    acc = padd<F, true>(acc, jac_load<F>(S + (size_t)t * 3 * E));
  }
  if (threadIdx.x == 0) jac_store<F>(out, acc);
}

inline dim3 grid_for(int n) { return dim3((n + kBlock - 1) / kBlock); }

}  // namespace zk

template <class S>
static int launch_addn(const int64_t* a, const int64_t* b, const int64_t* ia,
                       const int64_t* ib, const uint8_t* zero, int64_t* out,
                       int n, int64_t na, int64_t nb, int neg_b,
                       cudaStream_t s) {
  zk::k_addn<typename S::F, S::kBlock, S::kMin>
      <<<(n + S::kBlock - 1) / S::kBlock, S::kBlock, 0, s>>>(
          a, b, ia, ib, zero, out, n, na, nb, neg_b);
  return (int)cudaGetLastError();
}

using zk::Fp2Field;
using zk::Fp2FieldFast;
using zk::Fp2Warp;
using zk::FpField;
using zk::FpFieldFast;
using zk::FpWarp;

extern "C" {

int msm_prefix_rows(const int64_t* xy, const int64_t* payload, int64_t* out,
                    int W, int k, int lanes, int ncomp, int complete,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g = zk::grid_for(W * lanes);
  if (ncomp == 1 && complete)
    zk::k_prefix_rows<FpField, true><<<g, zk::kBlock, 0, s>>>(xy, payload, out, W, k, lanes);
  else if (ncomp == 1)
    zk::k_prefix_rows<FpField, false><<<g, zk::kBlock, 0, s>>>(xy, payload, out, W, k, lanes);
  else if (complete)
    zk::k_prefix_rows<Fp2Field, true><<<g, zk::kBlock, 0, s>>>(xy, payload, out, W, k, lanes);
  else
    zk::k_prefix_rows<Fp2Field, false><<<g, zk::kBlock, 0, s>>>(xy, payload, out, W, k, lanes);
  return (int)cudaGetLastError();
}

// One warp a lane, T in [1, 32]. mixed: complete or not; Jacobian:
// complete only (the wrapper checks).
int msm_prefix(const int64_t* in, int64_t* out, int k, int lanes, int ncomp,
               int mixed, int complete, int T, int log2s, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T < 1 || T > zk::kWarp) return (int)cudaErrorInvalidValue;
  dim3 g = zk::grid_for(lanes * zk::kWarp);
  if (ncomp == 1) {
    if (mixed && complete)
      zk::k_prefix<FpFieldFast, true, true><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes, T, log2s);
    else if (mixed)
      zk::k_prefix<FpFieldFast, true, false><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes, T, log2s);
    else
      zk::k_prefix<FpFieldFast, false, true><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes, T, log2s);
  } else {
    if (mixed && complete)
      zk::k_prefix<Fp2FieldFast, true, true><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes, T, log2s);
    else if (mixed)
      zk::k_prefix<Fp2FieldFast, true, false><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes, T, log2s);
    else
      zk::k_prefix<Fp2FieldFast, false, true><<<g, zk::kBlock, 0, s>>>(in, out, k, lanes, T, log2s);
  }
  return (int)cudaGetLastError();
}

// One warp a lane: kBlock / kWarp lanes a block. T in [1, 32].
int msm_wsum(const int64_t* in, int64_t* out, int L, int lanes, int ncomp,
             int T, int log2s, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T < 1 || T > zk::kWarp) return (int)cudaErrorInvalidValue;
  dim3 g = zk::grid_for(lanes * zk::kWarp);
  if (ncomp == 1)
    zk::k_wsum<FpField><<<g, zk::kBlock, 0, s>>>(in, out, L, lanes, T, log2s);
  else
    zk::k_wsum<Fp2Field><<<g, zk::kBlock, 0, s>>>(in, out, L, lanes, T, log2s);
  return (int)cudaGetLastError();
}

// ia, ib, zero may be null (design note); n >= 1.
int msm_addn(const int64_t* a, const int64_t* b, const int64_t* ia,
             const int64_t* ib, const uint8_t* zero, int64_t* out, int n,
             int64_t na, int64_t nb, int ncomp, int neg_b, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ncomp == 1)
    return launch_addn<zk::AddnShape<1>>(a, b, ia, ib, zero, out, n, na, nb,
                                         neg_b, s);
  return launch_addn<zk::AddnShape<2>>(a, b, ia, ib, zero, out, n, na, nb,
                                       neg_b, s);
}

// One warp a row: n blocks of 32 threads.
int msm_scale_add(const int64_t* a, const int64_t* b, int64_t* out, int n,
                  int ncomp, int log2s, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ncomp == 1)
    zk::k_scale_add<FpWarp><<<n, zk::kWarp, 0, s>>>(a, b, out, log2s);
  else
    zk::k_scale_add<Fp2Warp><<<n, zk::kWarp, 0, s>>>(a, b, out, log2s);
  return (int)cudaGetLastError();
}

int msm_horner(const int64_t* S, int64_t* out, int W, int ncomp, int c,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W < 1) return (int)cudaErrorInvalidValue;
  if (ncomp == 1)
    zk::k_horner<FpWarp><<<1, zk::kWarp, 0, s>>>(S, out, W, c);
  else
    zk::k_horner<Fp2Warp><<<1, zk::kWarp, 0, s>>>(S, out, W, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
