// Kernel P3: the Poseidon2 permutation (t = 4) and the ct_commitment sponge
// over BN254 Fr, for Hopper (sm_90a).
//
// It replaces no pl.pallas_call: the JAX package runs
// tpu_zkpool/hash/poseidon2.py:permutation (l.155) as an XLA lax.scan and
// ct_commitment (l.181) as 53 of them in sequence for the audit's 157
// packed fields. It computes what those compute, and is not a translation
// of the scan.
//
// The permutation (Barretenberg's Poseidon2 for BN254): the external mix
// M4 first, 4 full rounds (every word takes its round constant and x^5,
// then M4), 56 partial rounds (word 0 alone takes its constant and x^5,
// then the internal mix s_i <- u + d_i s_i, u the sum of the four words
// and d_i the mu_i - 1 values of DIAG_M1), 4 full rounds. M4 =
// [[5,7,1,3],[4,6,1,1],[1,3,5,7],[1,1,4,6]] is additions and doublings
// only. The sponge has rate 3 and capacity 1: each block of three fields is
// added to words 0..2 before a permutation, a remainder of rem fields to
// words 0..rem-1 before the last one (which runs for any n, n = 0
// included); the output is word 0.
//
// Bound: a chain of dependent product levels. A ciphertext's sponge over
// the audit's 157 fields is 53 permutations, each 192 levels; the card's
// multiply-add rate bounds it only once the warps fill its 528 schedulers,
// and the audit's 256 ciphertexts are 128 warps here.
//
// Form: 16 lanes a state (a ciphertext's whole sponge, or one state), two
// states a warp. Each state word is split over a group of kP2Split = 4
// lanes, two 32-bit words a lane (lanes.cuh): lanes 4w .. 4w + 3 of a state
// hold word w. Every product runs on its word's four lanes (split_mul, CIOS
// rows broadcast by shuffles: ~0.37 us a dependent product on the H100,
// where one thread's takes 0.60-0.67 us and a product a lane of a warp
// 0.74 us a level; chip_smoke.py phase 2, forms a, c, f and g), every
// addition carries across them (split_add: one round of ballots settles
// the carries and the compare with r). A round's three products are
// inlined (out of line, the call and its operands' moves cost ~0.06 us a
// product). Per round:
//   full round     each word adds its round constant and takes its own x^5
//                  (two squares and a product: 3 levels), then gathers the
//                  four words by shuffles and computes its own row of M4
//                  (rows 2 and 3 are rows 0 and 1 with the halves swapped,
//                  so every word runs one chain of 10 additions);
//   partial round  3 product levels, word 0 holding x = s_0 + c_r and word j
//                  s_j:
//                  level 1: x^2 on word 0, d_j s_j on word j;
//                  level 2: x^4 on word 0, mu_0 x on word 1 (mu_0 = d_0 + 1,
//                  formed once from DIAG_M1's d_0 and R mod r);
//                  level 3: x^5 = x^4 x on word 0, x^4 (mu_0 x) = mu_0 x^5
//                  on word 1;
//                  with u = x^5 + v, v = s_1 + s_2 + s_3, the round's
//                  s_0' = u + d_0 x^5 = mu_0 x^5 + v and s_j' = u + d_j s_j:
//                  v (a butterfly over the words) runs beside level 1, e =
//                  v + c_{r+1} on word 0 and v + d_j s_j on word j beside
//                  level 2, so after level 3 one addition gives word 0 the
//                  next x = mu_0 x^5 + e and word j its s_j' = x^5 + e.
// That is 3 levels a round, 192 a permutation, where one thread a state
// issued the permutation's 488 products one after another. Four words, not
// more: a round has at most four independent products (a full round's four
// S-boxes, a partial round's x^2 beside three diagonal products), so more
// groups a state shorten no level. Four lanes a word, not eight: form g
// takes ~0.43 us a product on 8. Every value is canonical, so the limbs
// equal the plain version's (hash/poseidon2.py:permutation_plain,
// ct_commitment_plain).
//
// Tables: 96 Fr values in Montgomery form as 8 little-endian 32-bit words
// each (hash/poseidon2.py:kernel_words): the external round constants (8 x
// 4, round order), the internal ones (56), the diagonal (4). Each block
// copies them into shared memory once; a lane reads its two words of a
// value (the 16 lanes of a state read 16 distinct 8-byte words of a full
// round's four constants, the two states of a warp the same ones).
//
// Storage is the port's layout, int64 16-bit limbs: a lane loads and stores
// the four limbs of its two words.
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/hash/poseidon2_kernels.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "lanes.cuh"

namespace zk {

constexpr int kP2Block = 128;  // threads a block, at most
constexpr int kP2Width = 4;
constexpr int kP2Split = 4;                      // lanes a word
constexpr int kP2Lanes = kP2Width * kP2Split;    // lanes a state
constexpr int kP2FullRounds = 8;
constexpr int kP2Half = kP2FullRounds / 2;
constexpr int kP2PartialRounds = 56;
constexpr int kP2Rate = 3;
// rows of the table: external constants, internal constants, diagonal
constexpr int kP2Ext = 0;
constexpr int kP2Int = kP2Ext + kP2FullRounds * kP2Width;
constexpr int kP2Diag = kP2Int + kP2PartialRounds;
constexpr int kP2Table = kP2Diag + kP2Width;  // 96 values

using FrS = Split<FrMod, kP2Split>;
static_assert(FrS::W == 2, "a lane holds one 8-byte pair of a value's words");

// A lane's place in its state: the word it holds part q of, the lane of the
// state's first word in the warp, the table (as 8-byte pairs of words) and
// its words of r and of R mod r (Montgomery one).
struct P2Lane {
  int w, q, base;
  const uint2* tab;
  FrS r, one;
  // part q of table value i (four pairs a value)
  __device__ __forceinline__ FrS at(int i) const {
    const uint2 v = tab[i * 4 + q];
    return {{v.x, v.y}};
  }
  // part q of word j of the state, for every lane
  __device__ __forceinline__ FrS word(const FrS& a, int j) const {
    return split_shfl(a, base + j * kP2Split + q);
  }
  __device__ __forceinline__ FrS add(const FrS& a, const FrS& b) const {
    return split_add(a, b, r);
  }
  __device__ __forceinline__ FrS mul(const FrS& a, const FrS& b) const {
    return split_mul(a, b, r);
  }
};

__device__ __forceinline__ FrS p2_xor(FrS a, int m) {
#pragma unroll
  for (int i = 0; i < FrS::W; ++i)
    a.v[i] = __shfl_xor_sync(0xffffffffu, a.v[i], m);
  return a;
}

// Word w's row of M4 s. With (A, B, C, D) = (s0, s1, s2, s3) on words 0, 1
// and (s2, s3, s0, s1) on words 2, 3: t0 = A + B, t2 = 2 B + (C + D), t3 =
// 2 D + t0, t5 = 4 t0 + t2; rows 0 and 2 are t3 + t5, rows 1 and 3 are t5
// (the Poseidon2 paper's chain for M4).
__device__ __forceinline__ FrS p2_m4(const FrS& s, const P2Lane& L) {
  const int h = L.w & 2;
  const FrS A = L.word(s, h), B = L.word(s, h + 1);
  const FrS C = L.word(s, h ^ 2), D = L.word(s, (h ^ 2) + 1);
  const FrS t0 = L.add(A, B);
  const FrS t2 = L.add(L.add(B, B), L.add(C, D));
  const FrS t3 = L.add(L.add(D, D), t0);
  const FrS t02 = L.add(t0, t0);
  const FrS t5 = L.add(L.add(t02, t02), t2);
  return split_pick(L.w & 1, t5, L.add(t3, t5));
}

__device__ __forceinline__ FrS p2_x5(const FrS& x, const P2Lane& L) {
  const FrS x2 = L.mul(x, x);
  const FrS x4 = L.mul(x2, x2);
  return L.mul(x4, x);
}

// The permutation of the state whose part (w, q) this lane holds in s;
// every lane of the warp calls it.
__device__ __forceinline__ FrS p2_permute(FrS s, const P2Lane& L) {
  const int w = L.w;
  s = p2_m4(s, L);
#pragma unroll 1
  for (int r = 0; r < kP2Half; ++r)
    s = p2_m4(p2_x5(L.add(s, L.at(kP2Ext + r * kP2Width + w)), L), L);
  // d_w, and mu_0 = d_0 + 1 (Montgomery one: R mod r)
  const FrS dw = L.at(kP2Diag + w), zero = {{0, 0}};
  const FrS mu0 = L.add(L.at(kP2Diag), L.one);
  // word 0 holds x = s_0 + c_r through the partial rounds, words 1..3 s_j
  s = L.add(s, split_pick(w, zero, L.at(kP2Int)));
#pragma unroll 1
  for (int r = 0; r < kP2PartialRounds; ++r) {
    // level 1: x^2 on word 0, d_w s_w on word w
    const FrS p1 = L.mul(split_pick(w, dw, s), s);
    // beside it: x to every word; v = s_1 + s_2 + s_3 by a butterfly
    const FrS x = L.word(s, 0);
    FrS v = split_pick(w, s, zero);
    v = L.add(v, p2_xor(v, kP2Split));
    v = L.add(v, p2_xor(v, 2 * kP2Split));
    // level 2: x^4 on word 0, mu_0 x on word 1
    const FrS p2 = L.mul(split_pick(w, mu0, p1), split_pick(w, x, p1));
    // beside it: e = v + c_{r+1} on word 0 (0 after the last round), v +
    // d_j s_j on word j
    const FrS c = r + 1 < kP2PartialRounds ? L.at(kP2Int + r + 1) : zero;
    const FrS e = L.add(v, split_pick(w, p1, c));
    // level 3: x^5 on word 0, x^4 (mu_0 x) = mu_0 x^5 on word 1
    const FrS p3 = L.mul(L.word(p2, 0), split_pick(w, p2, x));
    // s_0' + c_{r+1} = mu_0 x^5 + v + c_{r+1} on word 0, s_j' = x^5 + v +
    // d_j s_j on word j: one addition after the third level
    s = L.add(L.word(p3, w ? 0 : 1), e);
  }
#pragma unroll 1
  for (int r = kP2Half; r < kP2FullRounds; ++r)
    s = p2_m4(p2_x5(L.add(s, L.at(kP2Ext + r * kP2Width + w)), L), L);
  return s;
}

// Part q (limbs 4q .. 4q + 3) of the Fr at p.
__device__ __forceinline__ FrS p2_load(const int64_t* p, int q) {
  p += 4 * q;
  return {{(uint32_t)p[0] | ((uint32_t)p[1] << 16),
           (uint32_t)p[2] | ((uint32_t)p[3] << 16)}};
}

__device__ __forceinline__ void p2_store(int64_t* p, int q, const FrS& a) {
  p += 4 * q;
  p[0] = a.v[0] & 0xFFFFu;
  p[1] = a.v[0] >> 16;
  p[2] = a.v[1] & 0xFFFFu;
  p[3] = a.v[1] >> 16;
}

// MODE 0 (permutation): in (B, 4, 16) -> out (B, 4, 16).
// MODE 1 (sponge): in (B, n, 16) -> out (B, 16).
// tab (kP2Table, 8) words. kP2Lanes threads a state; blockDim.x a multiple
// of 32, so every warp is whole (a dead state runs on zeros and loads and
// stores nothing).
template <int MODE>
__global__ void __launch_bounds__(kP2Block)
k_poseidon2(const int64_t* __restrict__ in, int64_t* __restrict__ out,
            const uint4* __restrict__ tab, int B, int n) {
  __shared__ uint4 ptab[2 * kP2Table];
  for (int i = threadIdx.x; i < 2 * kP2Table; i += blockDim.x)
    ptab[i] = tab[i];
  __syncthreads();
  const int lane = threadIdx.x & (kP2Lanes - 1);
  const P2Lane L{lane / kP2Split, lane % kP2Split,
                 (int)(threadIdx.x & 31) - lane,
                 reinterpret_cast<const uint2*>(ptab),
                 split_modulus<FrMod, kP2Split>(),
                 split_one<FrMod, kP2Split>()};
  const long long h =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kP2Lanes;
  const bool live = h < B;
  FrS s = {{0, 0}};
  if constexpr (MODE == 0) {
    const size_t row = ((size_t)h * kP2Width + L.w) * 16;
    if (live) s = p2_load(in + row, L.q);
    s = p2_permute(s, L);
    if (live) p2_store(out + row, L.q, s);
  } else {
    const size_t row = (size_t)h * n * 16;
    const int full = n / kP2Rate;
    // blocks 0 .. full - 1 absorb three fields (words 0..2), block `full`
    // the remainder (possibly none); each is followed by one permutation
#pragma unroll 1
    for (int i = 0; i <= full; ++i) {
      const int take = i < full ? kP2Rate : n - kP2Rate * full;
      // every lane takes part in the addition; a word that absorbs
      // nothing adds zero
      FrS f = {{0, 0}};
      if (live && L.w < take)
        f = p2_load(in + row + (size_t)(kP2Rate * i + L.w) * 16, L.q);
      s = p2_permute(L.add(s, f), L);
    }
    if (live && L.w == 0) p2_store(out + (size_t)h * 16, L.q, s);
  }
}

}  // namespace zk

extern "C" {

// mode 0: B permutations of (B, 4, 16) states (n must be 4); mode 1: B
// sponges over (B, n, 16) packed fields, n >= 0. block: 32, 64 or 128
// threads, 16 a state.
int poseidon2(const int64_t* in, int64_t* out, const void* tab, int B, int n,
              int mode, int block, void* stream) {
  if (B < 1 || n < 0 || (mode != 0 && mode != 1) ||
      (mode == 0 && n != zk::kP2Width) || block < 32 ||
      block > zk::kP2Block || block % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* tb = (const uint4*)tab;
  const long long threads = (long long)B * zk::kP2Lanes;
  dim3 g((unsigned)((threads + block - 1) / block));
  if (mode == 0)
    zk::k_poseidon2<0><<<g, block, 0, s>>>(in, out, tb, B, n);
  else
    zk::k_poseidon2<1><<<g, block, 0, s>>>(in, out, tb, B, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
