// Kernel K7: the circomlib Poseidon hash over BN254 Fr for Hopper (sm_90a),
// templated on the state width t, instantiated for every width the
// parameters cover, t = 2 .. 17 (1 to 16 inputs; hash2 is t = 3).
//
// Replaces the Pallas kernel tpu_zkpool/hash/poseidon_pallas.py
// _make_kernel / _hash_tiles. It computes what _hash_tiles computes: state
// [0, in_1 .. in_{t-1}] in Montgomery Fr, R_F/2 = 4 full rounds, R_P partial
// rounds (N_ROUNDS_P[t - 2]: 56, 57, 56, 60, ... for t = 2, 3, 4, 5, ...),
// 4 full rounds; each round adds the
// round constants, applies x^5 (to every wire in a full round, to wire 0 in
// a partial one) and mixes out_i = sum_j M[i][j] s_j; the output is wire 0,
// canonical.
//
// Design. The TPU kernel held a tile of 1,024 hashes with one (8, 128)
// vector register per limb; here one thread holds one hash, its t state
// words in registers, converted from and to 16-bit limbs on load and store.
// The rounds run in a loop. Round constants and M are int64 limb tables in
// global memory (tpu_zkpool_torch/hash/poseidon.py:tables); every lane of
// a round reads the same address, so a warp's load is one broadcast. The
// MDS mix keeps the TPU kernel's lazy reduction: per output wire the t
// unreduced 512-bit products are summed, then reduced once (the sum is
// below t r^2 < r 2^256 for t <= 5, as redc_wide needs). A wider state
// reduces each output wire's products in groups of at most 5 and adds the
// canonical group sums mod r: the same value, so the same limbs. Above t =
// 5 the mix loops over the output wires without unrolling (the t states
// and outputs no longer fit the registers; the spill is reported by
// -Xptxas -v). Any B >= 1: the last block masks its tail.
//
// Bound: integer multiply-adds, counted in the least form known
// (chip_smoke.py:poseidon_madds): x^5 as two squares and one product, lazy
// mixes, the partial rounds in the Poseidon paper's sparse form (2t - 1
// products each) and the last mix for wire 0 alone: 126,256 multiply-adds
// for t = 3, 159,272 for t = 4, 205,856 for t = 5; the bytes ((t - 1) + 1
// rows of 128 B per hash) are far below. This kernel squares with the
// general product and mixes densely in every round. One thread per hash
// fills B threads, at most a few warps per SM at the tree's widths, so the
// kernel runs above that bound; the sparse partial rounds, more hashes per
// thread, inlined products and packed storage are later work.
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/hash/kernels.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace zk {

constexpr int kPoseidonBlock = 128;
constexpr int kFullRounds = 8;
constexpr int kMinWidth = 2;
constexpr int kLazyWires = 5;  // products summed before one reduction

// R_P by width t = 2 .. 17 (tpu_zkpool_torch/hash/poseidon_params.py).
__host__ __device__ constexpr int partial_rounds(int t) {
  constexpr int rp[] = {56, 57, 56, 60, 60, 63, 64, 63,
                        60, 66, 60, 65, 70, 60, 64, 68};
  return rp[t - kMinWidth];
}

// sum_{j in [j0, j1)} M[i][j] s_j, unreduced, then one reduction.
template <int T>
__device__ __forceinline__ Fr mix_group(const int64_t* __restrict__ mds,
                                        const Fr (&s)[T], int i, int j0,
                                        int j1) {
  uint32_t acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0;
#pragma unroll
  for (int j = 0; j < T; ++j)
    if (j >= j0 && j < j1) mac_wide(acc, fr_load(mds + (i * T + j) * 16), s[j]);
  return redc_wide<FrMod>(acc);
}

__device__ __forceinline__ Fr fr_x5(const Fr& x) {
  Fr x2 = fr_mul(x, x);
  Fr x4 = fr_mul(x2, x2);
  return fr_mul(x4, x);
}

// in (B, T-1, 16), out (B, 16), rc (R_F + R_P, T, 16), mds (T, T, 16).
template <int T>
__global__ void k_poseidon(const int64_t* __restrict__ in,
                           int64_t* __restrict__ out,
                           const int64_t* __restrict__ rc,
                           const int64_t* __restrict__ mds, int B) {
  constexpr int RP = partial_rounds(T);
  constexpr int HALF = kFullRounds / 2;
  int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= B) return;
  Fr s[T];
  s[0] = fr_zero();
#pragma unroll
  for (int w = 1; w < T; ++w)
    s[w] = fr_load(in + ((size_t)h * (T - 1) + (w - 1)) * 16);
#pragma unroll 1
  for (int r = 0; r < kFullRounds + RP; ++r) {
    const int64_t* c = rc + (size_t)r * T * 16;
#pragma unroll
    for (int w = 0; w < T; ++w) s[w] = fr_add(s[w], fr_load(c + w * 16));
    s[0] = fr_x5(s[0]);
    if (r < HALF || r >= HALF + RP) {
#pragma unroll
      for (int w = 1; w < T; ++w) s[w] = fr_x5(s[w]);
    }
    Fr o[T];
    if constexpr (T <= kLazyWires) {
#pragma unroll
      for (int i = 0; i < T; ++i) o[i] = mix_group<T>(mds, s, i, 0, T);
    } else {
#pragma unroll 1
      for (int i = 0; i < T; ++i) {
        Fr v = mix_group<T>(mds, s, i, 0, kLazyWires);
#pragma unroll
        for (int j0 = kLazyWires; j0 < T; j0 += kLazyWires)
          v = fr_add(v, mix_group<T>(mds, s, i, j0, j0 + kLazyWires));
        o[i] = v;
      }
    }
#pragma unroll
    for (int w = 0; w < T; ++w) s[w] = o[w];
  }
  fr_store(out + (size_t)h * 16, s[0]);
}

}  // namespace zk

extern "C" {

int poseidon_hash(const int64_t* in, int64_t* out, const int64_t* rc,
                  const int64_t* mds, int B, int t, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 g((B + zk::kPoseidonBlock - 1) / zk::kPoseidonBlock);
  switch (t) {
#define ZK_WIDTH(T_)                                                      \
  case T_:                                                                \
    zk::k_poseidon<T_><<<g, zk::kPoseidonBlock, 0, s>>>(in, out, rc, mds, B); \
    break;
    ZK_WIDTH(2) ZK_WIDTH(3) ZK_WIDTH(4) ZK_WIDTH(5) ZK_WIDTH(6) ZK_WIDTH(7)
    ZK_WIDTH(8) ZK_WIDTH(9) ZK_WIDTH(10) ZK_WIDTH(11) ZK_WIDTH(12)
    ZK_WIDTH(13) ZK_WIDTH(14) ZK_WIDTH(15) ZK_WIDTH(16) ZK_WIDTH(17)
#undef ZK_WIDTH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
