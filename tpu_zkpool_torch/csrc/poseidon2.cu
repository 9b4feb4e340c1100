// Kernel P3: the Poseidon2 permutation (t = 4) and the ct_commitment sponge
// over BN254 Fr, for Hopper (sm_90a).
//
// It replaces no pl.pallas_call: the JAX package runs
// tpu_zkpool/hash/poseidon2.py:permutation (l.155) as an XLA lax.scan and
// ct_commitment (l.181) as 53 of them in sequence for the audit's 157
// packed fields. It computes what those compute, and is not a translation
// of the scan: one thread walks one state (form a) or one ciphertext's
// whole sponge (form b), its four state words in registers.
//
// The permutation (Barretenberg's Poseidon2 for BN254): the external mix
// M4 first, 4 full rounds (every word takes its round constant and x^5,
// then M4), 56 partial rounds (word 0 alone takes its constant and x^5,
// then the internal mix s_i <- tot + d_i s_i, tot the sum of the four
// words and d_i the mu_i - 1 values of DIAG_M1), 4 full rounds. x^5 is two
// dedicated squares and one product; M4 = [[5,7,1,3],[4,6,1,1],[1,3,5,7],
// [1,1,4,6]] is the Poseidon2 paper's chain of 8 additions and 6
// doublings. The sponge has rate 3 and capacity 1: each block of three
// fields is added to words 0..2 before a permutation, a remainder of rem
// fields to words 0..rem-1 before the last one (which runs for any n,
// n = 0 included); the output is word 0.
//
// Tables: 96 Fr values in Montgomery form as 8 little-endian 32-bit words
// each (hash/poseidon2.py:kernel_words): the external round constants (8 x
// 4, round order), the internal ones (56), the diagonal (4). Each block
// copies them into shared memory once; every thread of a warp reads the
// same value at the same time, a broadcast.
//
// Bound: integer multiply-add issue. A permutation is 488 Fr products (96
// in the full rounds, 392 in the partial ones) of 264 32-bit multiply-adds
// each; the bytes (the inputs read once, the outputs written once) are
// below 0.1% of it. Chain floor: 248 dependent product levels a
// permutation (3 a full round, 4 a partial round). One thread a state keeps
// a state's 488 products on one lane; a later design can spread a partial
// round's four diagonal products over four lanes, as K7's lanes do.
//
// Storage is the port's layout, int64 16-bit limbs, converted to words in
// registers on load and store (field.cuh). Every value is canonical, so the
// limbs equal the plain version's (hash/poseidon2.py:permutation_plain,
// ct_commitment_plain).
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/hash/poseidon2_kernels.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace zk {

constexpr int kP2Block = 128;  // threads a block, at most
constexpr int kP2Width = 4;
constexpr int kP2FullRounds = 8;
constexpr int kP2Half = kP2FullRounds / 2;
constexpr int kP2PartialRounds = 56;
constexpr int kP2Rate = 3;
// rows of the table: external constants, internal constants, diagonal
constexpr int kP2Ext = 0;
constexpr int kP2Int = kP2Ext + kP2FullRounds * kP2Width;
constexpr int kP2Diag = kP2Int + kP2PartialRounds;
constexpr int kP2Table = kP2Diag + kP2Width;  // 96 values

__device__ __forceinline__ Fr p2_dbl(const Fr& a) { return fr_add(a, a); }

// s <- M4 s: t0 = s0 + s1, t1 = s2 + s3, t2 = 2 s1 + t1, t3 = 2 s3 + t0,
// t4 = 4 t1 + t3, t5 = 4 t0 + t2; M4 s = (t3 + t5, t5, t2 + t4, t4).
__device__ __forceinline__ void p2_m4(Fr (&s)[kP2Width]) {
  const Fr t0 = fr_add(s[0], s[1]);
  const Fr t1 = fr_add(s[2], s[3]);
  const Fr t2 = fr_add(p2_dbl(s[1]), t1);
  const Fr t3 = fr_add(p2_dbl(s[3]), t0);
  const Fr t4 = fr_add(p2_dbl(p2_dbl(t1)), t3);
  const Fr t5 = fr_add(p2_dbl(p2_dbl(t0)), t2);
  s[0] = fr_add(t3, t5);
  s[1] = t5;
  s[2] = fr_add(t2, t4);
  s[3] = t4;
}

__device__ __forceinline__ Fr p2_x5(const Fr& x) {
  const Fr x2 = fr_sqr(x);
  const Fr x4 = fr_sqr(x2);
  return fr_mul(x4, x);
}

__device__ __forceinline__ void p2_full_round(Fr (&s)[kP2Width],
                                              const Fr* c) {
#pragma unroll
  for (int w = 0; w < kP2Width; ++w) s[w] = p2_x5(fr_add(s[w], c[w]));
  p2_m4(s);
}

__device__ __forceinline__ void p2_permute(Fr (&s)[kP2Width], const Fr* tb) {
  p2_m4(s);
#pragma unroll 1
  for (int r = 0; r < kP2Half; ++r)
    p2_full_round(s, tb + kP2Ext + r * kP2Width);
#pragma unroll 1
  for (int r = 0; r < kP2PartialRounds; ++r) {
    s[0] = p2_x5(fr_add(s[0], tb[kP2Int + r]));
    const Fr tot = fr_add(fr_add(s[0], s[1]), fr_add(s[2], s[3]));
#pragma unroll
    for (int i = 0; i < kP2Width; ++i)
      s[i] = fr_add(tot, fr_mul(tb[kP2Diag + i], s[i]));
  }
#pragma unroll 1
  for (int r = kP2Half; r < kP2FullRounds; ++r)
    p2_full_round(s, tb + kP2Ext + r * kP2Width);
}

// MODE 0 (permutation): in (B, 4, 16) -> out (B, 4, 16).
// MODE 1 (sponge): in (B, n, 16) -> out (B, 16).
// tab (kP2Table, 8) words.
template <int MODE>
__global__ void __launch_bounds__(kP2Block)
k_poseidon2(const int64_t* __restrict__ in, int64_t* __restrict__ out,
            const uint4* __restrict__ tab, int B, int n) {
  __shared__ uint4 ptab[2 * kP2Table];
  for (int i = threadIdx.x; i < 2 * kP2Table; i += blockDim.x)
    ptab[i] = tab[i];
  __syncthreads();
  const Fr* tb = reinterpret_cast<const Fr*>(ptab);
  const long long h = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= B) return;
  Fr s[kP2Width];
  if constexpr (MODE == 0) {
    const int64_t* row = in + (size_t)h * kP2Width * 16;
#pragma unroll
    for (int w = 0; w < kP2Width; ++w) s[w] = fr_load(row + w * 16);
    p2_permute(s, tb);
#pragma unroll
    for (int w = 0; w < kP2Width; ++w)
      fr_store(out + ((size_t)h * kP2Width + w) * 16, s[w]);
  } else {
    const int64_t* row = in + (size_t)h * n * 16;
#pragma unroll
    for (int w = 0; w < kP2Width; ++w) s[w] = fr_zero();
    const int full = n / kP2Rate;
    // blocks 0 .. full - 1 absorb three fields, block `full` the
    // remainder (possibly none); each is followed by one permutation
#pragma unroll 1
    for (int i = 0; i <= full; ++i) {
      const int take = i < full ? kP2Rate : n - kP2Rate * full;
#pragma unroll
      for (int k = 0; k < kP2Rate; ++k)
        if (k < take)
          s[k] = fr_add(s[k], fr_load(row + (size_t)(kP2Rate * i + k) * 16));
      p2_permute(s, tb);
    }
    fr_store(out + (size_t)h * 16, s[0]);
  }
}

}  // namespace zk

extern "C" {

// mode 0: B permutations of (B, 4, 16) states (n must be 4); mode 1: B
// sponges over (B, n, 16) packed fields, n >= 0. block: 32, 64 or 128.
int poseidon2(const int64_t* in, int64_t* out, const void* tab, int B, int n,
              int mode, int block, void* stream) {
  if (B < 1 || n < 0 || (mode != 0 && mode != 1) ||
      (mode == 0 && n != zk::kP2Width) || block < 32 ||
      block > zk::kP2Block || block % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* tb = (const uint4*)tab;
  dim3 g((unsigned)((B + block - 1) / block));
  if (mode == 0)
    zk::k_poseidon2<0><<<g, block, 0, s>>>(in, out, tb, B, n);
  else
    zk::k_poseidon2<1><<<g, block, 0, s>>>(in, out, tb, B, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
