// A field element split over the K lanes of a group (K = 4 or 8, a power of
// two): lane q of a group holds words qW .. qW + W - 1 (W = 8 / K) of the
// Montgomery value. The product spreads each CIOS row over the lanes (form
// g of chip_smoke.py's product microbenchmark, csrc/mul_bench.cu): on the
// H100 a dependent product takes ~0.37 us on 4 lanes and ~0.43 us on 8,
// where one thread's takes 0.60-0.67 us (phase 2). P3 (csrc/poseidon2.cu)
// runs on K = 4, its three products a round inlined.
//
// Every function here is called by the whole warp (shuffles and ballots
// over all 32 lanes), each group on its own values; results are canonical
// (< the modulus) and equal mont_mul's and mont_add's words.
//
// The host rehearsal (g++ -DZK_HOST_TEST with ZK_HOST_THREADS) needs
// __ballot_sync, __shfl_up_sync and __shfl_down_sync (on uint32_t and
// uint64_t) besides field.cuh's shuffles.
#pragma once

#include <cstdint>
#include <type_traits>

#include "field.cuh"

namespace zk {

template <class M, int K>
struct Split {
  static constexpr int W = 8 / K;
  uint32_t v[W];
};

// This lane's words of the modulus.
template <class M, int K>
__device__ __forceinline__ Split<M, K> split_modulus() {
  constexpr int W = 8 / K;
  const int q = threadIdx.x & (K - 1);
  Split<M, K> p;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j / W == q) p.v[j % W] = M::p(j);
  return p;
}

// c ? a : b, word by word: a select of values in registers (a select of
// whole structs can compile to a select of their stack addresses and
// loads from local memory).
template <class M, int K>
__device__ __forceinline__ Split<M, K> split_pick(bool c, const Split<M, K>& a,
                                                  const Split<M, K>& b) {
  Split<M, K> r;
#pragma unroll
  for (int w = 0; w < Split<M, K>::W; ++w) r.v[w] = c ? a.v[w] : b.v[w];
  return r;
}

// This lane's words of R mod the modulus (Montgomery one).
template <class M, int K>
__device__ __forceinline__ Split<M, K> split_one() {
  constexpr int W = 8 / K;
  const int q = threadIdx.x & (K - 1);
  Split<M, K> one;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j / W == q) one.v[j % W] = M::r1(j);
  return one;
}

// Lane `src`'s words, for every lane of the warp.
template <class M, int K>
__device__ __forceinline__ Split<M, K> split_shfl(Split<M, K> a, int src) {
#pragma unroll
  for (int w = 0; w < Split<M, K>::W; ++w)
    a.v[w] = __shfl_sync(0xffffffffu, a.v[w], src);
  return a;
}

// The bit of each group's top lane in a warp of groups of K lanes.
template <int K>
__host__ __device__ constexpr uint32_t group_tops() {
  uint32_t m = 0;
  for (int i = K - 1; i < 32; i += K) m |= 1u << i;
  return m;
}

// The carry into each lane of the warp from the lanes below it in its
// group (bit l for lane l), from every lane's generate and propagate bits
// (disjoint): the carries of the addition (G | P) + G, the group tops cut
// off.
template <int K>
__device__ __forceinline__ uint32_t group_carries(uint32_t G, uint32_t P) {
  const uint32_t g = G & ~group_tops<K>(), x = g | (P & ~group_tops<K>());
  return (x + g) ^ x ^ g;
}

// The lane's words as one unsigned integer of 32 W bits, and back.
template <class M, int K>
using SplitInt = typename std::conditional<K == 4, uint64_t, uint32_t>::type;

template <class M, int K>
__device__ __forceinline__ SplitInt<M, K> split_int(const Split<M, K>& a) {
  if constexpr (K == 4)
    return a.v[0] | (uint64_t)a.v[1] << 32;
  else
    return a.v[0];
}

template <class M, int K>
__device__ __forceinline__ Split<M, K> split_of(SplitInt<M, K> x) {
  Split<M, K> r;
  r.v[0] = (uint32_t)x;
  if constexpr (K == 4) r.v[1] = (uint32_t)(x >> 32);
  return r;
}

// The group's value v = u + (each lane's carry out k, 0 or 1, owed to the
// lane above), v < 2p -> v mod p, canonical. One round of ballots settles
// both the carries and the compare with p: each lane forms u - p for a
// carry in of 0 and of 1 (its borrow out and whether it is zero), and the
// carries pick each lane's pair before the borrows' lookahead.
template <class M, int K>
__device__ __forceinline__ Split<M, K> split_settle(SplitInt<M, K> u, bool k,
                                                    const Split<M, K>& p) {
  using T = SplitInt<M, K>;
  const T P = split_int(p), u1 = u + 1;
  const uint32_t G = __ballot_sync(0xffffffffu, k);
  const uint32_t Q = __ballot_sync(0xffffffffu, u == ~T(0));
  const uint32_t B0 = __ballot_sync(0xffffffffu, u < P);
  const uint32_t Z0 = __ballot_sync(0xffffffffu, u == P);
  const uint32_t B1 = __ballot_sync(0xffffffffu, u1 < P);
  const uint32_t Z1 = __ballot_sync(0xffffffffu, u1 == P);
  const uint32_t C = group_carries<K>(G, Q);
  const uint32_t GB = (B1 & C) | (B0 & ~C), PB = (Z1 & C) | (Z0 & ~C);
  const uint32_t BB = group_carries<K>(GB, PB);
  const int lane = threadIdx.x & 31, top = lane | (K - 1);
  // the value is below p: the subtraction borrows out of the group's top
  const bool below = ((GB >> top) | ((PB >> top) & (BB >> top))) & 1u;
  const T v = (C >> lane) & 1u ? u1 : u;
  return split_of<M, K>(below ? v : v - P - ((BB >> lane) & 1u));
}

// (a + b) mod p, a and b canonical.
template <class M, int K>
__device__ __forceinline__ Split<M, K> split_add(const Split<M, K>& a,
                                                 const Split<M, K>& b,
                                                 const Split<M, K>& p) {
  const SplitInt<M, K> x = split_int(a), s = x + split_int(b);
  return split_settle(s, s < x, p);
}

// a b 2^-256 mod p. CIOS row i broadcasts a_i from the lane that holds it;
// the lane holding word 0 computes the quotient word m_i from its exact low
// word and broadcasts it; each lane adds a_i b_j and m_i p_j for its words
// into 64-bit partial sums (the high halves of its top word into one more
// sum, the next lane's bottom word), and the sums move down one word (the
// bottom one to the lane below). The carries are resolved once a product:
// each lane ripples its own words and hands its carry to the next lane,
// then split_settle passes the one-bit carries and subtracts p if due.
template <class M, int K>
__device__ __forceinline__ Split<M, K> split_mul(const Split<M, K>& a,
                                                 const Split<M, K>& b,
                                                 const Split<M, K>& p) {
  constexpr int W = 8 / K;
  const int q = threadIdx.x & (K - 1), base = (threadIdx.x & 31) - q;
  uint64_t S[W + 1];  // positions qW .. qW + W
#pragma unroll
  for (int w = 0; w <= W; ++w) S[w] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t ai = __shfl_sync(0xffffffffu, a.v[i % W], base + i / W);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t t = (uint64_t)ai * b.v[w];
      S[w] += (uint32_t)t;
      S[w + 1] += t >> 32;
    }
    const uint32_t m =
        __shfl_sync(0xffffffffu, (uint32_t)S[0] * M::n0, base);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint64_t t = (uint64_t)m * p.v[w];
      S[w] += (uint32_t)t;
      S[w + 1] += t >> 32;
    }
    // divide by 2^32: lane 0's bottom sum is a multiple of it (its high
    // part carries into the next word), every other lane's moves down
    const uint64_t down = __shfl_down_sync(0xffffffffu, S[0], 1);
    const uint64_t carry = q == 0 ? S[0] >> 32 : 0;
#pragma unroll
    for (int w = 0; w + 1 < W; ++w) S[w] = S[w + 1];
    S[W - 1] = S[W] + (q == K - 1 ? 0 : down);
    S[W] = 0;
    S[0] += carry;
  }
  // the value (< 2p) in words: the lane's own ripple, its carry (a few
  // bits) to the next lane, then the one-bit carries
  Split<M, K> u;
  uint64_t c = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    c += S[w];
    u.v[w] = (uint32_t)c;
    c >>= 32;
  }
  const uint32_t k = __shfl_up_sync(0xffffffffu, (uint32_t)c, 1);
  const SplitInt<M, K> v = split_int(u) + (q == 0 ? 0 : k);
  return split_settle(v, v < split_int(u), p);
}

}  // namespace zk
