// Kernel K7: the circomlib Poseidon hash over BN254 Fr for Hopper (sm_90a),
// for every width the parameters cover, t = 2 .. 17 (1 to 16 inputs; hash2
// is t = 3).
//
// Replaces the Pallas kernel tpu_zkpool/hash/poseidon_pallas.py
// _make_kernel / _hash_tiles. It computes what _hash_tiles computes: state
// [0, in_1 .. in_{t-1}] in Montgomery Fr, R_F/2 = 4 full rounds, R_P partial
// rounds (N_ROUNDS_P[t - 2]: 56, 57, 56, 60, ... for t = 2, 3, 4, 5, ...),
// 4 full rounds; each round adds the round constants, applies x^5 (to every
// wire in a full round, to wire 0 in a partial one) and mixes out_i =
// sum_j M[i][j] s_j; the output is wire 0, canonical.
//
// Form. The same permutation in the sparse form of the Poseidon paper's
// appendix B (tpu_zkpool_torch/hash/poseidon.py:sparse_form derives the
// tables exactly from the dense ones): the last full round of the first
// half mixes with a dense pre-matrix, each partial round adds one constant
// to wire 0 and mixes with a matrix of 2t - 1 nonzero entries (out_0 = w
// s_0 + sum v_j s_j, out_i = u_i s_0 + s_i), the last mix computes wire 0
// alone. x^5 is two dedicated squares and one product. The tables come as
// 32-bit Montgomery words (poseidon.py:kernel_tables) and each block
// copies them into shared memory once; every value is canonical, so the
// limbs equal the dense twin's.
//
// Two layouts, chosen by the wrapper (hash/kernels.py:layout) from B and
// t:
//   thread  one thread a hash, its t state words in registers: for batches
//           that fill the card, built for t <= 12 (wider states spill and
//           lose to the lanes at every batch on the H100). The mixes keep
//           the TPU kernel's lazy
//           reduction (the unreduced 512-bit products of up to five terms
//           summed, then one reduction; wider sums add the canonical group
//           sums mod r).
//   lanes   a group of G lanes a hash (G the power of two >= t + 1), lane w
//           holding wire w: for narrow batches (a Merkle tree's upper
//           levels), where one thread's chain of ~500 products is the
//           latency. A full round runs the t S-boxes on t lanes and each
//           lane mixes its own output from the shuffled state; a partial
//           round runs three product levels, each one product a lane (the
//           lanes run one instruction stream, so a level costs one
//           product): x^2, v_j s_j on lane j and w x on lane t; x^4 and u_j
//           x; then x^4 (u_j x) and x^4 (w x), and a butterfly over the
//           group sums the new wire 0.
//
// Bound: integer multiply-adds, counted in this sparse form
// (chip_smoke.py:poseidon_madds): 126,256 multiply-adds a hash for t = 3,
// 159,272 for t = 4, 205,856 for t = 5; the bytes ((t - 1) + 1 rows of 128
// B a hash) are far below. Chain floor (chip_smoke.py:poseidon_floor): a
// hash's dependent product levels times one level's time in the layout's
// form. Any B >= 1: the last block masks its tail.
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/hash/kernels.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace zk {

constexpr int kPoseidonBlock = 128;  // threads a block, at most
constexpr int kFullRounds = 8;
constexpr int kHalf = kFullRounds / 2;
constexpr int kMinWidth = 2;
constexpr int kMaxWidth = 17;
constexpr int kLazyWires = 5;  // products summed before one reduction

// R_P by width t = 2 .. 17 (tpu_zkpool_torch/hash/poseidon_params.py).
__host__ __device__ constexpr int partial_rounds(int t) {
  constexpr int rp[] = {56, 57, 56, 60, 60, 63, 64, 63,
                        60, 66, 60, 65, 70, 60, 64, 68};
  return rp[t - kMinWidth];
}

// The table of width t (poseidon.py:kernel_tables), in Fr values: c_full
// (8 x t), k (R_P), m (t x t), pre (t x t), sparse (R_P x (2t - 1)).
struct Layout {
  int k0, m0, pre0, sp0, size;
};
__host__ __device__ constexpr Layout table_layout(int t) {
  const int rp = partial_rounds(t);
  const int k0 = kFullRounds * t, m0 = k0 + rp, pre0 = m0 + t * t,
            sp0 = pre0 + t * t;
  return {k0, m0, pre0, sp0, sp0 + rp * (2 * t - 1)};
}
constexpr int kMaxTable = table_layout(kMaxWidth).size;

// Copy the table (2 uint4 a value) into shared memory; returns it as Fr.
__device__ __forceinline__ const Fr* load_table(uint4* sm,
                                                const uint4* __restrict__ tab,
                                                int size) {
  for (int i = threadIdx.x; i < 2 * size; i += blockDim.x) sm[i] = tab[i];
  __syncthreads();
  return reinterpret_cast<const Fr*>(sm);
}

__device__ __forceinline__ Fr fr_x5(const Fr& x) {
  const Fr x2 = fr_sqr(x);
  const Fr x4 = fr_sqr(x2);
  return fr_mul(x4, x);
}

// sum_{j in [j0, j1)} c[j] s_j: the unreduced products summed, one
// reduction (at most kLazyWires terms).
template <int T>
__device__ __forceinline__ Fr dot_group(const Fr* c, const Fr (&s)[T], int j0,
                                        int j1) {
  uint32_t acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0;
#pragma unroll
  for (int j = 0; j < T; ++j)
    if (j >= j0 && j < j1) mac_wide(acc, c[j], s[j]);
  return redc_wide<FrMod>(acc);
}

// sum_j c[j] s_j over all T wires.
template <int T>
__device__ __forceinline__ Fr dot(const Fr* c, const Fr (&s)[T]) {
  Fr v = dot_group<T>(c, s, 0, kLazyWires);
#pragma unroll
  for (int j0 = kLazyWires; j0 < T; j0 += kLazyWires)
    v = fr_add(v, dot_group<T>(c, s, j0, j0 + kLazyWires));
  return v;
}

// s <- m s, m row-major (T x T).
template <int T>
__device__ __forceinline__ void mix_dense(Fr (&s)[T], const Fr* m) {
  Fr o[T];
  if constexpr (T <= kLazyWires) {
#pragma unroll
    for (int i = 0; i < T; ++i) o[i] = dot<T>(m + i * T, s);
  } else {
#pragma unroll 1
    for (int i = 0; i < T; ++i) o[i] = dot<T>(m + i * T, s);
  }
#pragma unroll
  for (int w = 0; w < T; ++w) s[w] = o[w];
}

template <int T>
__device__ __forceinline__ void full_round(Fr (&s)[T], const Fr* c) {
#pragma unroll
  for (int w = 0; w < T; ++w) s[w] = fr_x5(fr_add(s[w], c[w]));
}

// ---------------------------------------------------- layout "thread"
// in (B, T-1, 16), out (B, 16); tab (size, 8) words.
template <int T>
__global__ void __launch_bounds__(kPoseidonBlock)
k_poseidon(const int64_t* __restrict__ in, int64_t* __restrict__ out,
           const uint4* __restrict__ tab, int B) {
  constexpr int RP = partial_rounds(T);
  constexpr Layout lay = table_layout(T);
  ZK_DYNAMIC_SHARED(uint4, ptab, 2 * kMaxTable);
  const Fr* tb = load_table(ptab, tab, lay.size);
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= B) return;
  Fr s[T];
  s[0] = fr_zero();
#pragma unroll
  for (int w = 1; w < T; ++w)
    s[w] = fr_load(in + ((size_t)h * (T - 1) + (w - 1)) * 16);
#pragma unroll 1
  for (int r = 0; r < kHalf; ++r) {
    full_round<T>(s, tb + r * T);
    mix_dense<T>(s, tb + (r == kHalf - 1 ? lay.pre0 : lay.m0));
  }
#pragma unroll 1
  for (int r = 0; r < RP; ++r) {
    s[0] = fr_x5(fr_add(s[0], tb[lay.k0 + r]));
    const Fr* sp = tb + lay.sp0 + r * (2 * T - 1);
    const Fr s0 = dot<T>(sp, s);
#pragma unroll
    for (int i = 1; i < T; ++i) s[i] = fr_add(s[i], fr_mul(sp[T - 1 + i], s[0]));
    s[0] = s0;
  }
#pragma unroll 1
  for (int r = kHalf; r < kFullRounds - 1; ++r) {
    full_round<T>(s, tb + r * T);
    mix_dense<T>(s, tb + lay.m0);
  }
  full_round<T>(s, tb + (kFullRounds - 1) * T);
  fr_store(out + (size_t)h * 16, dot<T>(tb + lay.m0, s));  // row 0 alone
}

// ----------------------------------------------------- layout "lanes"

__device__ __forceinline__ Fr shfl_fr(Fr a, int src) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a.v[i] = __shfl_sync(0xffffffffu, a.v[i], src);
  return a;
}

__device__ __forceinline__ Fr shfl_xor_fr(Fr a, int m) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a.v[i] = __shfl_xor_sync(0xffffffffu, a.v[i], m);
  return a;
}

// This lane's mix output sum_j m[wc][j] s_j, s_j on lane base + j: the
// unreduced products summed in groups of kLazyWires.
__device__ __forceinline__ Fr mix_lane(const Fr& s, const Fr* row, int t,
                                       int base) {
  Fr v = fr_zero();
#pragma unroll 1
  for (int j0 = 0; j0 < t; j0 += kLazyWires) {
    uint32_t acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0;
    const int j1 = min(j0 + kLazyWires, t);
#pragma unroll 1
    for (int j = j0; j < j1; ++j) mac_wide(acc, row[j], shfl_fr(s, base + j));
    v = fr_add(v, redc_wide<FrMod>(acc));
  }
  return v;
}

// in (B, t-1, 16), out (B, 16); G lanes a hash (G >= t + 1, G | 32);
// blockDim.x a multiple of 32, so every warp is whole (a dead group runs
// on zeros and stores nothing).
template <int G>
__global__ void __launch_bounds__(kPoseidonBlock)
k_poseidon_lanes(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                 const uint4* __restrict__ tab, int B, int t) {
  const int RP = partial_rounds(t);
  const Layout lay = table_layout(t);
  ZK_DYNAMIC_SHARED(uint4, ptab, 2 * kMaxTable);
  const Fr* tb = load_table(ptab, tab, lay.size);
  const int lane = threadIdx.x & 31, w = lane & (G - 1), base = lane - w;
  const long long h = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool live = h < B, wire = w < t, tail = w >= 1 && wire;
  const int wc = min(w, t - 1);  // a pad lane reads a real table row
  Fr s = fr_zero();
  if (live && tail) s = fr_load(in + ((size_t)h * (t - 1) + (w - 1)) * 16);
  const Fr zero = fr_zero();
#pragma unroll 1
  for (int r = 0; r < kHalf; ++r) {
    s = fr_x5(fr_add(s, tb[r * t + wc]));
    s = mix_lane(s, tb + (r == kHalf - 1 ? lay.pre0 : lay.m0) + wc * t, t,
                 base);
    s = wire ? s : zero;
  }
#pragma unroll 1
  for (int r = 0; r < RP; ++r) {
    const Fr x = fr_add(shfl_fr(s, base), tb[lay.k0 + r]);
    const Fr* sp = tb + lay.sp0 + r * (2 * t - 1);
    // level 1: x^2 on lane 0, v_j s_j on lane j, w x on lane t
    const Fr p1 = fr_mul(tail ? sp[w] : w == t ? sp[0] : x, tail ? s : x);
    // level 2: x^4 on lane 0, u_j x on lane j
    const Fr p2 = fr_mul(tail ? sp[t - 1 + w] : p1, tail ? x : p1);
    const Fr x4 = shfl_fr(p2, base);
    // level 3: x^4 u_j x on lane j, x^4 w x on lane t
    const Fr p3 = fr_mul(x4, w == t ? p1 : p2);
    Fr term = tail ? p1 : w == t ? p3 : zero;
    s = tail ? fr_add(s, p3) : s;
#pragma unroll
    for (int m = 1; m < G; m <<= 1) term = fr_add(term, shfl_xor_fr(term, m));
    s = w == 0 ? term : s;
  }
#pragma unroll 1
  for (int r = kHalf; r < kFullRounds; ++r) {
    s = fr_x5(fr_add(s, tb[r * t + wc]));
    s = mix_lane(s, tb + lay.m0 + wc * t, t, base);
    s = wire ? s : zero;
  }
  if (live && w == 0) fr_store(out + (size_t)h * 16, s);
}

}  // namespace zk

namespace {

// Tables above 48 KB (t >= 11) need the kernel's opt-in.
template <class K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// lanes = 0: one thread a hash (t <= 12); lanes = G (4, 8, 16 or 32): G
// lanes a hash. block: 32, 64 or 128 threads. As hash/kernels.py:layout
// gives them.
int poseidon_hash(const int64_t* in, int64_t* out, const void* tab, int B,
                  int t, int lanes, int block, void* stream) {
  if (t < zk::kMinWidth || t > zk::kMaxWidth || block < 32 ||
      block > zk::kPoseidonBlock || block % 32 ||
      (lanes && (lanes < t + 1 || lanes > 32 || (lanes & (lanes - 1)))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* tb = (const uint4*)tab;
  const size_t smem = (size_t)zk::table_layout(t).size * 32;
  const long long threads = (long long)B * (lanes ? lanes : 1);
  dim3 g((unsigned)((threads + block - 1) / block));
  int rc = 0;
  if (lanes) {
    switch (lanes) {
#define ZK_LANES(G_)                                                       \
  case G_:                                                                 \
    rc = allow_smem(zk::k_poseidon_lanes<G_>, smem);                   \
    if (!rc)                                                               \
      zk::k_poseidon_lanes<G_><<<g, block, smem, s>>>(in, out, tb, B, t);  \
    break;
      ZK_LANES(4) ZK_LANES(8) ZK_LANES(16) ZK_LANES(32)
#undef ZK_LANES
    }
  } else {
    switch (t) {
#define ZK_WIDTH(T_)                                                     \
  case T_:                                                               \
    rc = allow_smem(zk::k_poseidon<T_>, smem);                       \
    if (!rc) zk::k_poseidon<T_><<<g, block, smem, s>>>(in, out, tb, B);  \
    break;
      ZK_WIDTH(2) ZK_WIDTH(3) ZK_WIDTH(4) ZK_WIDTH(5) ZK_WIDTH(6) ZK_WIDTH(7)
      ZK_WIDTH(8) ZK_WIDTH(9) ZK_WIDTH(10) ZK_WIDTH(11) ZK_WIDTH(12)
#undef ZK_WIDTH
      default:  // t > 12: lanes only (hash/kernels.py:THREAD_MAX_T)
        return (int)cudaErrorInvalidValue;
    }
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
