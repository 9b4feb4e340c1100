// BN254 base field Fp (and Fp2 = Fp[u]/(u^2 + 1)) and scalar field Fr on
// Hopper: 8 x 32-bit word Montgomery arithmetic, R = 2^256, every result
// canonical (< the modulus).
//
// Replaces the register-limb field helpers the Pallas kernels inline:
// tpu_zkpool/hash/poseidon_pallas.py _mul_cols/_reduce/_cond_sub_p/_mont_mul/
// _add_mod and tpu_zkpool/curve/curve_pallas.py _sub_mod/_dbl_mod/_is_zero,
// and the Fp2 adapter tpu_zkpool/msm/grid.py:_Fp2. The TPU built a product
// from 16 x 16-bit limbs because its vector unit has no 32 x 32 -> 64-bit
// multiply; Hopper has one (IMAD.WIDE), so a product is 8 x 8 word steps of
// CIOS (coarsely integrated operand scanning) with 64-bit accumulators.
//
// The word functions are templates on a modulus-traits struct (FpMod,
// FrMod); Fp = Mont<FpMod> and Fr = Mont<FrMod>. Both primes are below
// 2^254, so the same bounds hold for both (a CIOS result is < 2p before its
// one conditional subtraction).
//
// Storage stays the port's public layout, int64[16] 16-bit limbs, and is
// converted to words in registers on load and store. Because R is the same
// and results are canonical, every value equals the plain torch twin
// (tpu_zkpool_torch/fields/fctx.py) limb for limb.
//
// Bound: integer multiply-add issue. A product is 64 + 64 word products
// (product and reduction rows), each a lo and a hi 32-bit multiply-add, and
// 8 quotient words of one low product each: 264 multiply-adds, plus the
// final subtraction. Split (mul_wide, then redc_wide), the unreduced product
// is 128 of them and the reduction 136.
#pragma once

#include <cstdint>

#ifdef ZK_HOST_TEST
// Host rehearsal: g++ -DZK_HOST_TEST builds this header (and a kernel
// source) for a machine without a GPU. The CUDA keywords go away; a harness
// that runs a kernel's threads defines ZK_HOST_THREADS and its own
// threadIdx, blockIdx, blockDim, __syncthreads and shuffles, otherwise one
// thread of one block is assumed.
#define __device__
#define __host__
#define __constant__
#define __global__
#define __shared__ static
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#include <algorithm>
#include <cstdlib>
using std::max;
using std::min;
inline void __trap() { std::abort(); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
#ifndef ZK_HOST_THREADS
struct ZkDim3 {
  unsigned x, y, z;
};
inline ZkDim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
inline uint32_t __shfl_sync(unsigned, uint32_t v, int, int = 32) { return v; }
#endif
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(16) longlong2 {
  long long x, y;
};
inline longlong2 make_longlong2(long long x, long long y) { return {x, y}; }
// dynamic shared memory: a static array of `host_count` elements
#define ZK_DYNAMIC_SHARED(T, name, host_count) alignas(16) static T name[host_count]
#else
#define ZK_DYNAMIC_SHARED(T, name, host_count) \
  extern __shared__ __align__(16) T name[]
#endif

namespace zk {

// p = 21888242871839275222246405745257275088696311157297823662689037894645226208583
__device__ __constant__ uint32_t kP[8] = {
    0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// R mod p (Montgomery one)
__device__ __constant__ uint32_t kR1[8] = {
    0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
    0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
// -p^-1 mod 2^32
constexpr uint32_t kN0 = 0xe4866389u;

// r = 21888242871839275222246405745257275088548364400416034343698204186575808495617
__device__ __constant__ uint32_t kFrP[8] = {
    0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
    0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
// R mod r (Montgomery one)
__device__ __constant__ uint32_t kFrR1[8] = {
    0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
    0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
// -r^-1 mod 2^32
constexpr uint32_t kFrN0 = 0xefffffffu;

// Modulus traits: word i of the modulus and of R mod modulus, and n0.
struct FpMod {
  __device__ static __forceinline__ uint32_t p(int i) { return kP[i]; }
  __device__ static __forceinline__ uint32_t r1(int i) { return kR1[i]; }
  static constexpr uint32_t n0 = kN0;
};

struct FrMod {
  __device__ static __forceinline__ uint32_t p(int i) { return kFrP[i]; }
  __device__ static __forceinline__ uint32_t r1(int i) { return kFrR1[i]; }
  static constexpr uint32_t n0 = kFrN0;
};

// An element in Montgomery form, 8 little-endian 32-bit words.
template <class M>
struct Mont {
  uint32_t v[8];
};

using Fp = Mont<FpMod>;
using Fr = Mont<FrMod>;

template <class M>
__device__ __forceinline__ Mont<M> mont_zero() {
  Mont<M> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0;
  return r;
}

template <class M>
__device__ __forceinline__ Mont<M> mont_one() {
  Mont<M> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = M::r1(i);
  return r;
}

// t - p if t >= p else t, for t < 2p (no carry out of word 7).
template <class M>
__device__ __forceinline__ Mont<M> mont_reduce_once(const Mont<M>& t) {
  Mont<M> d;
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t x = (int64_t)t.v[i] - M::p(i) + borrow;
    d.v[i] = (uint32_t)x;
    borrow = x >> 32;  // 0 or -1
  }
  return borrow ? t : d;
}

template <class M>
__device__ __forceinline__ Mont<M> mont_add(const Mont<M>& a, const Mont<M>& b) {
  Mont<M> s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c += (uint64_t)a.v[i] + b.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return mont_reduce_once(s);
}

template <class M>
__device__ __forceinline__ Mont<M> mont_sub(const Mont<M>& a, const Mont<M>& b) {
  Mont<M> d;
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t x = (int64_t)a.v[i] - b.v[i] + borrow;
    d.v[i] = (uint32_t)x;
    borrow = x >> 32;
  }
  if (borrow) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c += (uint64_t)d.v[i] + M::p(i);
      d.v[i] = (uint32_t)c;
      c >>= 32;
    }
  }
  return d;
}

template <class M>
__device__ __forceinline__ bool mont_is_zero(const Mont<M>& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) o |= a.v[i];
  return o == 0;
}

// ------------------------------------------------------- product forms
//
// mont_mul_n: N independent Montgomery products in one thread, CIOS row i
// of every product issued before row i + 1 of any. FORM selects the row:
//   kRowC   64-bit C accumulators (the compiler's IMAD.WIDE chains), the
//           arithmetic of mont_mul;
//   kRowPtx 32-bit PTX carry chains (mad.lo.cc / madc.hi.cc / addc).
// Both give mont_mul's canonical limbs. chip_smoke.py's microbenchmark
// (csrc/mul_bench.cu) times them on an H100: one thread's product is bound
// by the issue of its multiply-adds, not by its carry chain's latency
// (three interleaved products cost 2.8-3.7 times one), inlining gains
// nothing consistent over the out-of-line call (0.65-0.70 us an Fp
// product either way), and the inlined PTX row is the faster single
// product (0.61 us). So K2 and K6 run one out-of-line product of the PTX
// row, fp_mul_fast, and K6 spreads a level's independent products over the
// lanes of a warp (FpWarp, Fp2Warp below), where three products cost about
// one (0.74 us). ZK_HOST_TEST builds the header with a C++ compiler for
// testing on a machine without a GPU: the PTX helpers then emulate the
// carry flag.

constexpr int kRowC = 0;
constexpr int kRowPtx = 1;

#ifdef ZK_HOST_TEST
inline thread_local uint32_t zk_cc = 0;  // the emulated carry flag
__device__ __forceinline__ uint32_t cc_op(uint64_t s, bool set) {
  if (set) zk_cc = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_op((uint64_t)(uint32_t)((uint64_t)a * b) + c, true);
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_op((uint64_t)(uint32_t)((uint64_t)a * b) + c + zk_cc, true);
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_op((((uint64_t)a * b) >> 32) + c, true);
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return cc_op((((uint64_t)a * b) >> 32) + c + zk_cc, true);
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  return cc_op((uint64_t)a + b + zk_cc, true);
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  return cc_op((uint64_t)a + b + zk_cc, false);
}
#else
// Each chain runs as consecutive volatile asm statements (their order is
// kept), the carry flag passing from one to the next.
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
#endif

// One CIOS row of t (10 words, t < 2p on entry): t = (t + a b_i + m p) /
// 2^32 with m = (t + a b_i) n0 mod 2^32; t < 2p again on exit.
template <class M, int FORM>
__device__ __forceinline__ void cios_row(uint32_t t[10], const Mont<M>& a,
                                         uint32_t bi) {
  if constexpr (FORM == kRowC) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)t[j] + (uint64_t)a.v[j] * bi;
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * M::n0;
    c = ((uint64_t)m * M::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)t[j] + (uint64_t)m * M::p(j);
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  } else {
    // t += a b_i: the low halves into words 0..7, then the high halves
    // into words 1..8 (t < 2^255 + 2^288 fits 10 words)
    t[0] = mad_lo_cc(a.v[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = madc_lo_cc(a.v[j], bi, t[j]);
    t[8] = addc_cc(t[8], 0);
    t[9] = addc(0, 0);
    t[1] = mad_hi_cc(a.v[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j + 1] = madc_hi_cc(a.v[j], bi, t[j + 1]);
    t[9] = addc(t[9], 0);
    // t += m p, word 0 becomes zero; then shift down one word
    uint32_t m = t[0] * M::n0;
    t[0] = mad_lo_cc(m, M::p(0), t[0]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j] = madc_lo_cc(m, M::p(j), t[j]);
    t[8] = addc_cc(t[8], 0);
    t[9] = addc(t[9], 0);
    t[1] = mad_hi_cc(m, M::p(0), t[1]);
#pragma unroll
    for (int j = 1; j < 8; ++j) t[j + 1] = madc_hi_cc(m, M::p(j), t[j + 1]);
    t[9] = addc(t[9], 0);
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
  }
}

// r[k] = a[k] b[k] 2^-256 mod p, k < N, canonical; rows interleaved.
template <class M, int FORM, int N>
__device__ __forceinline__ void mont_mul_n(Mont<M>* r, const Mont<M>* a,
                                           const Mont<M>* b) {
  uint32_t t[N][10];
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 10; ++i) t[k][i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) cios_row<M, FORM>(t[k], a[k], b[k].v[i]);
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[k].v[i] = t[k][i];
    r[k] = mont_reduce_once(r[k]);  // t < 2p < 2^255: t[8] == 0
  }
}

// Montgomery product a * b * 2^-256 mod p (CIOS, 64-bit C accumulators).
template <class M>
__device__ __forceinline__ Mont<M> mont_mul(const Mont<M>& a, const Mont<M>& b) {
  Mont<M> r;
  mont_mul_n<M, kRowC, 1>(&r, &a, &b);
  return r;
}

// acc += a * b, the full 512-bit product, unreduced. The caller keeps the
// sum below 2^512 (and below p * 2^256 for redc_wide).
template <class M>
__device__ __forceinline__ void mac_wide(uint32_t acc[16], const Mont<M>& a,
                                         const Mont<M>& b) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)w[i + j] + (uint64_t)a.v[j] * b.v[i];
      w[i + j] = (uint32_t)c;
      c >>= 32;
    }
    w[i + 8] = (uint32_t)c;  // word i + 8 is still zero here
  }
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    c += (uint64_t)acc[i] + w[i];
    acc[i] = (uint32_t)c;
    c >>= 32;
  }
}

// Montgomery reduction T * 2^-256 mod p of T < p * 2^256 (16 words, which
// it overwrites), canonical.
template <class M>
__device__ __forceinline__ Mont<M> redc_wide(uint32_t T[16]) {
  uint32_t hi = 0;  // carry out of word i + 8, owed to word i + 9
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t m = T[i] * M::n0;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)T[i + j] + (uint64_t)m * M::p(j);
      T[i + j] = (uint32_t)c;
      c >>= 32;
    }
    c += (uint64_t)T[i + 8] + hi;
    T[i + 8] = (uint32_t)c;
    hi = (uint32_t)(c >> 32);
  }
  Mont<M> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = T[i + 8];
  return mont_reduce_once(r);  // (T + m p) / 2^256 < 2p < 2^255: hi == 0
}

// a^2 2^-256 mod p, canonical: the square's 36 distinct word products (the
// 28 off the diagonal once, then doubled, and the 8 squares), 72
// multiply-adds where a product's unreduced half takes 128, then redc_wide.
template <class M>
__device__ __forceinline__ Mont<M> mont_sqr(const Mont<M>& a) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < 8; ++j) {
      c += (uint64_t)w[i + j] + (uint64_t)a.v[i] * a.v[j];
      w[i + j] = (uint32_t)c;
      c >>= 32;
    }
    w[i + 8] = (uint32_t)c;  // word i + 8 is still zero here
  }
#pragma unroll
  for (int k = 15; k > 0; --k) w[k] = (w[k] << 1) | (w[k - 1] >> 31);
  w[0] <<= 1;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t d = (uint64_t)a.v[i] * a.v[i];
    c += (uint64_t)w[2 * i] + (uint32_t)d;
    w[2 * i] = (uint32_t)c;
    c = (c >> 32) + w[2 * i + 1] + (d >> 32);
    w[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
  return redc_wide<M>(w);  // a^2 < p^2 < p 2^256
}

// int64[16] 16-bit limbs <-> words.
template <class M>
__device__ __forceinline__ Mont<M> mont_load(const int64_t* p) {
  Mont<M> r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.v[i] = (uint32_t)p[2 * i] | ((uint32_t)p[2 * i + 1] << 16);
  return r;
}

template <class M>
__device__ __forceinline__ void mont_store(int64_t* p, const Mont<M>& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    p[2 * i] = a.v[i] & 0xFFFFu;
    p[2 * i + 1] = a.v[i] >> 16;
  }
}

// ------------------------------------------------------------------- Fp

__device__ __forceinline__ Fp fp_zero() { return mont_zero<FpMod>(); }
__device__ __forceinline__ Fp fp_one() { return mont_one<FpMod>(); }
__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  return mont_add(a, b);
}
__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  return mont_sub(a, b);
}
__device__ __forceinline__ Fp fp_dbl(const Fp& a) { return mont_add(a, a); }
__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  return mont_is_zero(a);
}

// Kept out of line: it is called from every point formula, and inlining it
// everywhere multiplies the build time for little gain in this first
// version.
__device__ __noinline__ Fp fp_mul(const Fp a, const Fp b) {
  return mont_mul(a, b);
}

// Out of line, as fp_mul: the dedicated square.
__device__ __noinline__ Fp fp_sqr(const Fp a) { return mont_sqr(a); }

__device__ __forceinline__ Fp fp_load(const int64_t* p) {
  return mont_load<FpMod>(p);
}
__device__ __forceinline__ void fp_store(int64_t* p, const Fp& a) {
  mont_store(p, a);
}

// The same limbs, two a load or store: limbs 2i and 2i + 1 are one
// longlong2 and word i (p 16-byte aligned).
__device__ __forceinline__ Fp fp_load2(const int64_t* p) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
  Fp r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const longlong2 w = q[i];
    r.v[i] = (uint32_t)w.x | ((uint32_t)w.y << 16);
  }
  return r;
}
__device__ __forceinline__ void fp_store2(int64_t* p, const Fp& a) {
  longlong2* q = reinterpret_cast<longlong2*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    q[i] = make_longlong2(a.v[i] & 0xFFFFu, a.v[i] >> 16);
}

// ------------------------------------------------------------------- Fr

__device__ __forceinline__ Fr fr_zero() { return mont_zero<FrMod>(); }
__device__ __forceinline__ Fr fr_add(const Fr& a, const Fr& b) {
  return mont_add(a, b);
}
// Out of line, as fp_mul.
__device__ __noinline__ Fr fr_mul(const Fr a, const Fr b) {
  return mont_mul(a, b);
}
__device__ __noinline__ Fr fr_sqr(const Fr a) { return mont_sqr(a); }
__device__ __forceinline__ Fr fr_load(const int64_t* p) {
  return mont_load<FrMod>(p);
}
__device__ __forceinline__ void fr_store(int64_t* p, const Fr& a) {
  mont_store(p, a);
}

// ------------------------------------------------------------ field traits
//
// kWarp: the trait computes a dependency level's products through muls
// across a warp's lanes (FpWarp, Fp2Warp); point.cuh's level() otherwise
// calls mul once a product.

struct FpField {
  using T = Fp;
  static constexpr int NC = 1;
  static constexpr bool kWarp = false;
  __device__ static T zero() { return fp_zero(); }
  __device__ static T one() { return fp_one(); }
  __device__ static T add(const T& a, const T& b) { return fp_add(a, b); }
  __device__ static T sub(const T& a, const T& b) { return fp_sub(a, b); }
  __device__ static T dbl(const T& a) { return fp_dbl(a); }
  __device__ static T mul(const T& a, const T& b) { return fp_mul(a, b); }
  __device__ static bool is_zero(const T& a) { return fp_is_zero(a); }
  __device__ static T load(const int64_t* p) { return fp_load(p); }
  __device__ static void store(int64_t* p, const T& a) { fp_store(p, a); }
  __device__ static T load2(const int64_t* p) { return fp_load2(p); }
  __device__ static void store2(int64_t* p, const T& a) {
    fp_store2(p, a);
  }
};

struct Fp2 {
  Fp c0, c1;
};

// Fp2 = Fp[u]/(u^2 + 1) over the base traits B (their product), Karatsuba
// as tpu_zkpool/msm/grid.py:_Fp2.mul.
template <class B>
struct Fp2Over {
  using T = Fp2;
  static constexpr int NC = 2;
  static constexpr bool kWarp = false;
  __device__ static T zero() { return {fp_zero(), fp_zero()}; }
  __device__ static T one() { return {fp_one(), fp_zero()}; }
  __device__ static T add(const T& a, const T& b) {
    return {fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
  }
  __device__ static T sub(const T& a, const T& b) {
    return {fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
  }
  __device__ static T dbl(const T& a) { return {fp_dbl(a.c0), fp_dbl(a.c1)}; }
  __device__ static T mul(const T& a, const T& b) {
    Fp t0 = B::mul(a.c0, b.c0);
    Fp t1 = B::mul(a.c1, b.c1);
    Fp t2 = B::mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
    return {fp_sub(t0, t1), fp_sub(fp_sub(t2, t0), t1)};
  }
  __device__ static bool is_zero(const T& a) {
    return fp_is_zero(a.c0) && fp_is_zero(a.c1);
  }
  __device__ static T load(const int64_t* p) {
    return {fp_load(p), fp_load(p + 16)};
  }
  __device__ static void store(int64_t* p, const T& a) {
    fp_store(p, a.c0);
    fp_store(p + 16, a.c1);
  }
  __device__ static T load2(const int64_t* p) {
    return {fp_load2(p), fp_load2(p + 16)};
  }
  __device__ static void store2(int64_t* p, const T& a) {
    fp_store2(p, a.c0);
    fp_store2(p + 16, a.c1);
  }
};

using Fp2Field = Fp2Over<FpField>;

// ------------------------------------------------ the traits of K2 and K6

// The row form of fp_mul_fast: the faster inlined single product of the
// microbenchmark (form c against form b); out of line it matches fp_mul
// over Fp and is ~7% faster inside an Fp2 product (forms e and a).
constexpr int kFastRow = kRowPtx;

// Out of line, as fp_mul: one copy of the product's code, which a kernel
// calls from every formula (inlined everywhere, the formulas outgrew the
// instruction cache: K6 ran 1.95 ms over Fp and 12.3 ms over Fp2 against
// 1.76 and 6.08 out of line, on the H100).
__device__ __noinline__ Fp fp_mul_fast(const Fp a, const Fp b) {
  Fp r;
  mont_mul_n<FpMod, kFastRow, 1>(&r, &a, &b);
  return r;
}

// FpField and Fp2Field on fp_mul_fast: the same values (K2).
struct FpFieldFast : FpField {
  __device__ static T mul(const T& a, const T& b) { return fp_mul_fast(a, b); }
};

using Fp2FieldFast = Fp2Over<FpFieldFast>;

// Word w of lane `src`'s Fp, for every lane of the warp.
__device__ __forceinline__ Fp shfl_fp(Fp a, int src) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a.v[i] = __shfl_sync(0xffffffffu, a.v[i], src);
  return a;
}

// The warp traits of K6: every lane of one warp holds the same values, and
// muls<M> computes a dependency level's M independent products r[i] = a[i]
// b[i] with one product a lane (lane i; over Fp2, lane 3 i + c computes
// Karatsuba product c of pair i), then hands every product to every lane
// by shuffles. The values are mul's, so the formulas give the same limbs
// on these traits as on FpField and Fp2Field. The whole warp calls it.
struct FpWarp : FpFieldFast {
  static constexpr bool kWarp = true;
  template <int M>
  __device__ static void muls(T (&r)[M], const T (&a)[M], const T (&b)[M]) {
    const int k = min((int)(threadIdx.x % 32), M - 1);
    T x = a[0], y = b[0];
#pragma unroll
    for (int i = 1; i < M; ++i)
      if (k == i) x = a[i], y = b[i];
    const T p = fp_mul_fast(x, y);
#pragma unroll
    for (int i = 0; i < M; ++i) r[i] = shfl_fp(p, i);
  }
};

struct Fp2Warp : Fp2FieldFast {
  static constexpr bool kWarp = true;
  template <int M>
  __device__ static void muls(T (&r)[M], const T (&a)[M], const T (&b)[M]) {
    const int lane = threadIdx.x % 32;
    const int k = min(lane / 3, M - 1), c = lane % 3;
    Fp x = a[0].c0, y = b[0].c0;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (k != i) continue;
      x = c == 0 ? a[i].c0 : c == 1 ? a[i].c1 : fp_add(a[i].c0, a[i].c1);
      y = c == 0 ? b[i].c0 : c == 1 ? b[i].c1 : fp_add(b[i].c0, b[i].c1);
    }
    const Fp p = fp_mul_fast(x, y);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      Fp t0 = shfl_fp(p, 3 * i), t1 = shfl_fp(p, 3 * i + 1),
         t2 = shfl_fp(p, 3 * i + 2);
      r[i] = {fp_sub(t0, t1), fp_sub(fp_sub(t2, t0), t1)};
    }
  }
};

// ------------------------------------------------------ Fp inversion (K8)
//
// fp_inv: a^-1, Montgomery in and out (a != 0; 0 maps to 0), the
// constant-time safegcd: a fixed count of divsteps with selects by masks,
// no branch and no early exit on the data, as the JAX kernel's Fermat
// chain has none. chip_smoke.py's inverse microbenchmark (csrc/mul_bench.cu,
// with the two Fermat forms it was chosen over) times it and holds it to
// Fermat's limbs.
//
// Bernstein-Yang "safegcd" (Bernstein and Yang, Fast constant-time
// gcd computation and modular inversion, 2019) in the form of
// libsecp256k1's constant-time modinv32: values in nine signed 30-bit
// limbs, divsteps in batches of 30 on the low limbs, each batch a 2x2
// transition matrix (entries in [-2^30, 2^30]) applied to f, g and to the
// Bezout coefficients d, e mod p. 20 batches, 600 divsteps: the half-delta
// divstep needs at most 590 for any modulus and input below 2^256
// (libsecp256k1's bound for its modinv32 / modinv64, computed with the
// convex-hull method of Bernstein and Yang, section 11), and p < 2^254.
// The input aR (Montgomery) inverts to a^-1 R^-1, and one Montgomery
// product with R^3 mod p gives a^-1 R.
constexpr int kDivstepBatches = 20;
constexpr int kDivsteps = 30;
constexpr int32_t kM30 = 0x3FFFFFFF;
// p in signed 30-bit limbs, p^-1 mod 2^30, and R^3 mod p in words
__device__ __constant__ int32_t kP30[9] = {
    0x187cfd47, 0x3082305b, 0x071ca8d3, 0x205aa45a, 0x01585d97,
    0x0116da06, 0x1a029b85, 0x139cb84c, 0x00003064};
constexpr uint32_t kPInv30 = 0x1b799c77u;
__device__ __constant__ uint32_t kR3[8] = {
    0xda1530dfu, 0xb1cd6dafu, 0xa7283db6u, 0x62f210e6u,
    0x0ada0afbu, 0xef7f0b0cu, 0x2d592544u, 0x20fd6e90u};

struct Divsteps {
  int32_t u, v, q, r;
};

// 30 divsteps on the low words of f (odd) and g; zeta = -(delta + 1/2).
// The matrix (u v; q r) maps (f, g) to 2^30 times the new (f, g). Each
// step: if g is odd, g += f (or -f when zeta < 0, and then f takes the old
// g); g /= 2. ((a ^ c1) - c1) & c2 is written ((a ^ c1) & c2) - (c1 & c2),
// one three-input logic op and one three-input add.
__device__ __forceinline__ int32_t divsteps30(int32_t zeta, uint32_t f,
                                              uint32_t g, Divsteps& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < kDivsteps; ++i) {
    const uint32_t c1 = (uint32_t)(zeta >> 31);         // zeta < 0
    const uint32_t c2 = (uint32_t)((int32_t)(g << 31) >> 31);  // g odd
    const uint32_t c3 = c1 & c2;  // swap: zeta < 0 and g odd
    g += ((f ^ c1) & c2) - c3;
    q += ((u ^ c1) & c2) - c3;
    r += ((v ^ c1) & c2) - c3;
    zeta = (zeta ^ (int32_t)c3) - 1;
    f += g & c3;
    u = (u + (q & c3)) << 1;
    v = (v + (r & c3)) << 1;
    g >>= 1;
  }
  t = {(int32_t)u, (int32_t)v, (int32_t)q, (int32_t)r};
  return zeta;
}

// (f, g) <- (u f + v g, q f + r g) / 2^30, exact.
__device__ __forceinline__ void update_fg30(int32_t f[9], int32_t g[9],
                                            const Divsteps& t) {
  int64_t cf = (int64_t)t.u * f[0] + (int64_t)t.v * g[0];
  int64_t cg = (int64_t)t.q * f[0] + (int64_t)t.r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cf += (int64_t)t.u * f[i] + (int64_t)t.v * g[i];
    cg += (int64_t)t.q * f[i] + (int64_t)t.r * g[i];
    f[i - 1] = (int32_t)cf & kM30;
    cf >>= 30;
    g[i - 1] = (int32_t)cg & kM30;
    cg >>= 30;
  }
  f[8] = (int32_t)cf;
  g[8] = (int32_t)cg;
}

// (d, e) <- (u d + v e, q d + r e) / 2^30 mod p, kept in (-2p, p): a
// multiple of p (md, me, chosen by masks) clears the low 30 bits.
__device__ __forceinline__ void update_de30(int32_t d[9], int32_t e[9],
                                            const Divsteps& t) {
  const int32_t sd = d[8] >> 31, se = e[8] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d[0] + (int64_t)t.v * e[0];
  int64_t ce = (int64_t)t.q * d[0] + (int64_t)t.r * e[0];
  md -= (int32_t)((kPInv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
  me -= (int32_t)((kPInv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
  cd += (int64_t)kP30[0] * md;
  ce += (int64_t)kP30[0] * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cd += (int64_t)t.u * d[i] + (int64_t)t.v * e[i] + (int64_t)kP30[i] * md;
    ce += (int64_t)t.q * d[i] + (int64_t)t.r * e[i] + (int64_t)kP30[i] * me;
    d[i - 1] = (int32_t)cd & kM30;
    cd >>= 30;
    e[i - 1] = (int32_t)ce & kM30;
    ce >>= 30;
  }
  d[8] = (int32_t)cd;
  e[8] = (int32_t)ce;
}

// d in (-2p, p) -> sign * d mod p in [0, p), limbs in [0, 2^30).
__device__ __forceinline__ void normalize30(int32_t d[9], int32_t sign) {
  int32_t add = d[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d[i] += kP30[i] & add;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d[i] = (d[i] ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] &= kM30;
  }
  add = d[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d[i] += kP30[i] & add;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d[i + 1] += d[i] >> 30;
    d[i] &= kM30;
  }
}

__device__ __noinline__ Fp fp_inv(const Fp a) {
  int32_t f[9], g[9], d[9], e[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {  // g = aR, bits 30 i .. 30 i + 29
    const int o = 30 * i, k = o >> 5;
    const uint64_t x = (uint64_t)a.v[k] |
                       ((uint64_t)(k + 1 < 8 ? a.v[k + 1] : 0u) << 32);
    g[i] = (int32_t)((x >> (o & 31)) & (uint64_t)kM30);
    f[i] = kP30[i];
    d[i] = 0;
    e[i] = i == 0;
  }
  int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int b = 0; b < kDivstepBatches; ++b) {
    Divsteps t;
    zeta = divsteps30(zeta, (uint32_t)f[0], (uint32_t)g[0], t);
    update_de30(d, e, t);
    update_fg30(f, g, t);
  }
  // g = 0 and f = +-1 now; d = +-(aR)^-1
  normalize30(d, f[8]);
  Fp y;
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // bits 32 k .. 32 k + 31
    const int o = 32 * k, i = o / 30, s = o % 30;
    y.v[k] = (uint32_t)(((uint64_t)d[i] >> s) | ((uint64_t)d[i + 1] << (30 - s)));
  }
  Fp r3;
#pragma unroll
  for (int k = 0; k < 8; ++k) r3.v[k] = kR3[k];
  return fp_mul(y, r3);
}

}  // namespace zk
