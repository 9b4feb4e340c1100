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

// Montgomery product a * b * 2^-256 mod p (CIOS).
template <class M>
__device__ __forceinline__ Mont<M> mont_mul(const Mont<M>& a, const Mont<M>& b) {
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i];
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
  }
  Mont<M> r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = t[i];
  return mont_reduce_once(r);  // t < 2p < 2^255, so t[8] == 0
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

__device__ __forceinline__ Fp fp_load(const int64_t* p) {
  return mont_load<FpMod>(p);
}
__device__ __forceinline__ void fp_store(int64_t* p, const Fp& a) {
  mont_store(p, a);
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
__device__ __forceinline__ Fr fr_load(const int64_t* p) {
  return mont_load<FrMod>(p);
}
__device__ __forceinline__ void fr_store(int64_t* p, const Fr& a) {
  mont_store(p, a);
}

// ------------------------------------------------------------ field traits

struct FpField {
  using T = Fp;
  static constexpr int NC = 1;
  __device__ static T zero() { return fp_zero(); }
  __device__ static T one() { return fp_one(); }
  __device__ static T add(const T& a, const T& b) { return fp_add(a, b); }
  __device__ static T sub(const T& a, const T& b) { return fp_sub(a, b); }
  __device__ static T dbl(const T& a) { return fp_dbl(a); }
  __device__ static T mul(const T& a, const T& b) { return fp_mul(a, b); }
  __device__ static T sqr(const T& a) { return fp_mul(a, a); }
  __device__ static bool is_zero(const T& a) { return fp_is_zero(a); }
  __device__ static T load(const int64_t* p) { return fp_load(p); }
  __device__ static void store(int64_t* p, const T& a) { fp_store(p, a); }
};

struct Fp2 {
  Fp c0, c1;
};

// Fp2 = Fp[u]/(u^2 + 1), Karatsuba as tpu_zkpool/msm/grid.py:_Fp2.mul.
struct Fp2Field {
  using T = Fp2;
  static constexpr int NC = 2;
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
    Fp t0 = fp_mul(a.c0, b.c0);
    Fp t1 = fp_mul(a.c1, b.c1);
    Fp t2 = fp_mul(fp_add(a.c0, a.c1), fp_add(b.c0, b.c1));
    return {fp_sub(t0, t1), fp_sub(fp_sub(t2, t0), t1)};
  }
  __device__ static T sqr(const T& a) { return mul(a, a); }
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
};

}  // namespace zk
