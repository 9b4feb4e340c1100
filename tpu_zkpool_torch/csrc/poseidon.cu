// Kernel K7: the circomlib Poseidon hash over BN254 Fr for Hopper (sm_90a),
// templated on the state width t (instantiated for t = 3, 4, 5: hash2,
// hash3, hash4).
//
// Replaces the Pallas kernel tpu_zkpool/hash/poseidon_pallas.py
// _make_kernel / _hash_tiles. It computes what _hash_tiles computes: state
// [0, in_1 .. in_{t-1}] in Montgomery Fr, R_F/2 = 4 full rounds, R_P partial
// rounds (57, 56, 60 for t = 3, 4, 5), 4 full rounds; each round adds the
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
// below t r^2 < r 2^256 for t <= 5, as redc_wide needs). Any B >= 1: the
// last block masks its tail.
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

__host__ __device__ constexpr int partial_rounds(int t) {
  return t == 3 ? 57 : t == 4 ? 56 : 60;
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
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint32_t acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0;
#pragma unroll
      for (int j = 0; j < T; ++j)
        mac_wide(acc, fr_load(mds + (i * T + j) * 16), s[j]);
      o[i] = redc_wide<FrMod>(acc);
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
  if (t == 3)
    zk::k_poseidon<3><<<g, zk::kPoseidonBlock, 0, s>>>(in, out, rc, mds, B);
  else if (t == 4)
    zk::k_poseidon<4><<<g, zk::kPoseidonBlock, 0, s>>>(in, out, rc, mds, B);
  else if (t == 5)
    zk::k_poseidon<5><<<g, zk::kPoseidonBlock, 0, s>>>(in, out, rc, mds, B);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
