// Pairing kernels P1 (k_miller_lines) and P2 (k_final_exp) for Hopper
// (sm_90a): the device side of the batched Groth16 verify, one thread a
// batch element, over BN254 Fp2 / Fp12 built on field.cuh's Fp.
//
// They replace no pl.pallas_call. The JAX package compiles
// tpu_zkpool/curve/pairing_jax.py:miller_loop_lines (l.412) and
// :final_exponentiation (l.305) into one XLA program (_ppl_jit); the port's
// FieldCtx would run the same work as ~1.5-2 million small torch kernels a
// batch, so each is one kernel here, with its plain torch version in
// tpu_zkpool_torch/curve/pairing.py (over curve/tower.py).
//
// P1 computes miller_loop_lines: for up to 3 legs, each a G1 point (px, py)
// and its precomputed line coefficients (curve/lines.py: alpha_neg = -lam
// and beta = lam t_x - t_y, per ATE step a double line and an add line,
// then two Frobenius end lines), f = 1; per step f = f^2, then each leg's
// double line, then where the ATE bit is set each leg's add line (the JAX
// scan computes both and selects: the same value); then the end lines. A
// line is l0 + l1 w + l3 w^3 with l0 = py, l1 = alpha_neg px (two Fp
// products), l3 = beta, multiplied in sparse form: 18 Fp2 products, six of
// them by l0 in Fp (2 Fp products each), where the JAX dense form takes 36.
// The square is the complex method over Fp6 (Fp12 = Fp6[w]/(w^2 - v), v =
// w^2, v^3 = xi): two Karatsuba Fp6 products, 36 Fp products.
//
// P2 computes final_exponentiation: f^-1 (the even-subalgebra trick of
// pairing_jax.f12_inv, the Fp2 norm inverted by field.cuh's safegcd
// fp_inv), the easy part, then the Scott et al. hard part as straight-line
// code in the order of the plain version's register program
// (curve/pairing.py FE_PROGRAM, the JAX _fe_program): Fp12 products,
// Granger-Scott cyclotomic squares, Frobenius maps with the gamma tables of
// constant memory and conjugations, each value a named local, so the
// compiler knows every lifetime. An Fp12 product is the Karatsuba form over
// Fp6, 54 Fp products; a cyclotomic square 18.
//
// Every value is canonical Montgomery (R = 2^256), so every form gives the
// limbs of the plain version. Layout: Fp12 int64[B, 12, 16], row 2 i + c
// the component c of the coefficient of w^i (the JAX order); lines and
// points the port's int64 16-bit limbs.
//
// Design: one thread a batch element, blocks of 32 threads, so a batch of
// 256 runs on 8 SMs; the Fp12 values live in registers and, where those run
// out, in local memory. Bound: the instruction rate of the Fp products (one
// thread's product is ~1,300 instructions, field.cuh); the chain of one
// element is the whole loop, so a launch takes at least its dependent
// products times one product's latency (chip_smoke.py: pairing_floor). A
// warp a batch element, an Fp12 product's independent Fp2 products on its
// lanes (K6's form), is the next step.
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/curve/pairing_kernels.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace zk {

constexpr int kPairThreads = 32;
constexpr int kMaxLegs = 3;
constexpr int kAteSteps = 64;
// 6x + 2 without its leading bit, step 0 at bit 63 (curve/lines.py ATE_BITS)
constexpr uint64_t kAteBits = 0x9d797039be763ba8ull;
// BN_X, the curve parameter, and its length in bits (fields/bn254.py)
constexpr uint64_t kBnX = 0x44e992b44a6909f1ull;
constexpr int kBnXBits = 63;

// Frobenius coefficients xi^(i (p^k - 1) / 6), k = 1, 2, 3, i = 0 .. 5, as
// Montgomery words (c0, c1) (refimpl/pairing_ref.py _gamma).
__device__ __constant__ uint32_t kGamma[3][6][2][8] = {
    {  // p^1
     {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x33144907u, 0xaf9ba696u, 0x87afb78au, 0xca6b1d73u, 0xf08a2087u, 0x11bded5eu, 0x1a1f3a7cu, 0x02f34d75u},
      {0x4c492d72u, 0xa222ae23u, 0x565de15bu, 0xd00f02a4u, 0x53dfc926u, 0xdc2ff3a2u, 0xb3899551u, 0x10a75716u}},
     {{0x4563ab30u, 0xb5773b10u, 0xa9aa6454u, 0x347f91c8u, 0x242e0991u, 0x7a007127u, 0x118214ecu, 0x1956bcd8u},
      {0xa0aa4757u, 0x6e849f1eu, 0x89f89141u, 0xaa1c7b6du, 0xfae0ca3au, 0xb6e713cdu, 0x4e82ebc3u, 0x26694fbbu}},
     {{0x2936b629u, 0xe4bbdd0cu, 0xe133bacbu, 0xbb30f162u, 0xf9645366u, 0x31a9d1b6u, 0xa500f8ddu, 0x253570beu},
      {0x5ffe77c7u, 0xa1d77ce4u, 0x7826d1dbu, 0x07affd11u, 0xbb7edc6bu, 0x6d16bd27u, 0x85defeccu, 0x2c872002u}},
     {{0x843abe92u, 0x7361d77fu, 0x273411fbu, 0xa5bb2bd3u, 0x4b3e2399u, 0x9c941f31u, 0xbb9fd3ecu, 0x15df9cddu},
      {0x4bd8c949u, 0x5dddfd15u, 0xa4445b60u, 0x62cb29a5u, 0x0c7dd2b9u, 0x37bc870au, 0x3171f0fdu, 0x24830a9du}},
     {{0x41690fe7u, 0xc970692fu, 0x27694b0bu, 0xe2403421u, 0x83c459e8u, 0x32bee66bu, 0x0ab08841u, 0x12aabcedu},
      {0x40aebfa9u, 0x0d485d23u, 0xab2fcc57u, 0x05193418u, 0x8a4910f5u, 0xd3b0a40bu, 0x35d2925au, 0x2f21ebb5u}}},
    {  // p^2
     {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x00fa1bf2u, 0xca8d8005u, 0x68b39769u, 0xf0c5d614u, 0xad0d4418u, 0x0e201271u, 0xbad856e6u, 0x04290f65u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x13e80b9cu, 0x3350c88eu, 0xdb5e56b9u, 0x7dce557cu, 0xb615564au, 0x6001b4b8u, 0x020217e0u, 0x2682e617u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x12edefaau, 0x68c34889u, 0x72aabf4fu, 0x8d087f68u, 0x09081231u, 0x51e1a247u, 0x4729c0fau, 0x2259d6b1u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0xd782e155u, 0x71930c11u, 0xffbe3323u, 0xa6bb947cu, 0xd4741444u, 0xaa303344u, 0x26594943u, 0x2c3b3f0du},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0xc494f1abu, 0x08cfc388u, 0x8d1373d4u, 0x19b31514u, 0xcb6c0213u, 0x584e90fdu, 0xdf2f8849u, 0x09e1685bu},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}}},
    {  // p^3
     {{0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u, 0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
      {0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000000u}},
     {{0x4e46d97du, 0x36531618u, 0xd4c96d9fu, 0x0af7129eu, 0xca1009b5u, 0x659da72fu, 0x83a20d23u, 0x08116d89u},
      {0xc39c1939u, 0xb1df4af7u, 0x8a73bf7fu, 0x3d9f0287u, 0x8caf0ae0u, 0x9b222092u, 0xeff054a6u, 0x26684515u}},
     {{0x16ad6badu, 0xc9af22f7u, 0x4aa662b2u, 0xb311782au, 0xe248c7f4u, 0x19eeaf64u, 0xe3439f82u, 0x20273e77u},
      {0xf7ce93acu, 0xacc02860u, 0x7ba76b4cu, 0x3933d581u, 0x446c8467u, 0x69e6188bu, 0x4417cc55u, 0x0a46036du}},
     {{0xaf46471eu, 0x5764af0au, 0x873e0fc1u, 0xdc50792eu, 0x881d04f6u, 0x86a673ffu, 0x3c30a74cu, 0x0b2eddb4u},
      {0x787e8580u, 0x9a490f32u, 0xf04af8b1u, 0x8fd16d7fu, 0xc6027bf2u, 0x4b39888eu, 0x5b52a15du, 0x03dd2e70u}},
     {{0x7b6762dfu, 0x448a93a5u, 0x28fdeadfu, 0xbfd62df5u, 0x0e9bd47au, 0xd858f5d0u, 0x3476ec58u, 0x06b03d4du},
      {0xbcc936d1u, 0x2b19daf4u, 0x56f4299fu, 0xa1a54e7au, 0x5adeaef1u, 0xb533eee0u, 0x84dda0b2u, 0x170c812bu}},
     {{0x75cf559fu, 0xe0bc4b22u, 0xc154e60fu, 0xc238b945u, 0x929a7d5eu, 0x803982a5u, 0xf7e4a37eu, 0x15ce052du},
      {0xbf3799a7u, 0x2d28efbdu, 0x1ad60773u, 0x9b097e3cu, 0xaf4a535bu, 0x982d4113u, 0xe3056063u, 0x24e18991u}}}
};

// ----------------------------------------------------------------- Fp2

using F2 = Fp2Field;

__device__ __forceinline__ Fp2 f2_add(const Fp2& a, const Fp2& b) {
  return F2::add(a, b);
}
__device__ __forceinline__ Fp2 f2_sub(const Fp2& a, const Fp2& b) {
  return F2::sub(a, b);
}
__device__ __forceinline__ Fp2 f2_dbl(const Fp2& a) { return F2::dbl(a); }
__device__ __forceinline__ Fp2 f2_mul(const Fp2& a, const Fp2& b) {
  return F2::mul(a, b);
}
__device__ __forceinline__ Fp2 f2_neg(const Fp2& a) {
  return {fp_sub(fp_zero(), a.c0), fp_sub(fp_zero(), a.c1)};
}
__device__ __forceinline__ Fp2 f2_conj(const Fp2& a) {
  return {a.c0, fp_sub(fp_zero(), a.c1)};
}
// (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 Fp products
__device__ __forceinline__ Fp2 f2_sqr(const Fp2& a) {
  const Fp t = fp_mul(a.c0, a.c1);
  return {fp_mul(fp_add(a.c0, a.c1), fp_sub(a.c0, a.c1)), fp_dbl(t)};
}
// a times an Fp scalar: 2 Fp products
__device__ __forceinline__ Fp2 f2_mul_fp(const Fp2& a, const Fp& s) {
  return {fp_mul(a.c0, s), fp_mul(a.c1, s)};
}
// a (9 + u) = (9 a0 - a1) + (a0 + 9 a1) u
__device__ __forceinline__ Fp2 f2_mul_xi(const Fp2& a) {
  const Fp2 a8 = f2_dbl(f2_dbl(f2_dbl(a)));
  const Fp2 a9 = f2_add(a8, a);
  return {fp_sub(a9.c0, a.c1), fp_add(a.c0, a9.c1)};
}
// 1 / a: the norm a0^2 + a1^2 inverted by the safegcd (0 maps to 0)
__device__ __forceinline__ Fp2 f2_inv(const Fp2& a) {
  const Fp n = fp_add(fp_mul(a.c0, a.c0), fp_mul(a.c1, a.c1));
  const Fp ni = fp_inv(n);
  return {fp_mul(a.c0, ni), fp_sub(fp_zero(), fp_mul(a.c1, ni))};
}

// --------------------------------------------------------- Fp6 and Fp12

struct Fp6 {
  Fp2 a, b, c;  // a + b v + c v^2, v^3 = xi
};

struct Fp12 {
  Fp2 c[6];  // sum c[i] w^i, w^6 = xi
};

__device__ __forceinline__ Fp6 f6_add(const Fp6& x, const Fp6& y) {
  return {f2_add(x.a, y.a), f2_add(x.b, y.b), f2_add(x.c, y.c)};
}
__device__ __forceinline__ Fp6 f6_sub(const Fp6& x, const Fp6& y) {
  return {f2_sub(x.a, y.a), f2_sub(x.b, y.b), f2_sub(x.c, y.c)};
}
// x v = xi c + a v + b v^2
__device__ __forceinline__ Fp6 f6_mul_v(const Fp6& x) {
  return {f2_mul_xi(x.c), x.a, x.b};
}
// Karatsuba over Fp2: 6 Fp2 products, 18 Fp products
__device__ __noinline__ Fp6 f6_mul(const Fp6 x, const Fp6 y) {
  const Fp2 v0 = f2_mul(x.a, y.a), v1 = f2_mul(x.b, y.b),
            v2 = f2_mul(x.c, y.c);
  const Fp2 t0 = f2_sub(f2_sub(f2_mul(f2_add(x.b, x.c), f2_add(y.b, y.c)),
                               v1), v2);
  const Fp2 t1 = f2_sub(f2_sub(f2_mul(f2_add(x.a, x.b), f2_add(y.a, y.b)),
                               v0), v1);
  const Fp2 t2 = f2_sub(f2_sub(f2_mul(f2_add(x.a, x.c), f2_add(y.a, y.c)),
                               v0), v2);
  return {f2_add(v0, f2_mul_xi(t0)), f2_add(t1, f2_mul_xi(v2)),
          f2_add(t2, v1)};
}

__device__ __forceinline__ Fp6 f12_even(const Fp12& x) {
  return {x.c[0], x.c[2], x.c[4]};
}
__device__ __forceinline__ Fp6 f12_odd(const Fp12& x) {
  return {x.c[1], x.c[3], x.c[5]};
}
__device__ __forceinline__ Fp12 f12_from(const Fp6& g, const Fp6& h) {
  return {{g.a, h.a, g.b, h.b, g.c, h.c}};
}

__device__ __forceinline__ Fp12 f12_one() {
  Fp12 r;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.c[i] = F2::zero();
  r.c[0] = F2::one();
  return r;
}

__device__ __forceinline__ Fp12 f12_conj(const Fp12& x) {
  return {{x.c[0], f2_neg(x.c[1]), x.c[2], f2_neg(x.c[3]), x.c[4],
           f2_neg(x.c[5])}};
}

// (g + h w)(g' + h' w) = (g g' + h h' v) + ((g + h)(g' + h') - g g' - h h') w:
// three Fp6 products, 54 Fp products
__device__ __noinline__ Fp12 f12_mul(const Fp12 x, const Fp12 y) {
  const Fp6 g = f12_even(x), h = f12_odd(x), g2 = f12_even(y),
            h2 = f12_odd(y);
  const Fp6 t0 = f6_mul(g, g2), t1 = f6_mul(h, h2);
  const Fp6 s = f6_mul(f6_add(g, h), f6_add(g2, h2));
  return f12_from(f6_add(t0, f6_mul_v(t1)), f6_sub(f6_sub(s, t0), t1));
}

// (g + h w)^2 = ((g + h)(g + v h) - g h - v g h) + 2 g h w: two Fp6
// products, 36 Fp products
__device__ __noinline__ Fp12 f12_sqr(const Fp12 x) {
  const Fp6 g = f12_even(x), h = f12_odd(x);
  const Fp6 gh = f6_mul(g, h);
  const Fp6 s = f6_mul(f6_add(g, h), f6_add(g, f6_mul_v(h)));
  return f12_from(f6_sub(f6_sub(s, gh), f6_mul_v(gh)), f6_add(gh, gh));
}

// f (l0 + l1 w + l3 w^3), l0 in Fp: 18 Fp2 products (6 of them by l0, 2
// Fp products each), 48 Fp products. Coefficient k gathers f_k l0,
// f_(k-1) l1 and f_(k-3) l3, a wrapped index times xi.
__device__ __noinline__ Fp12 f12_mul_line(const Fp12 f, const Fp l0,
                                          const Fp2 l1, const Fp2 l3) {
  Fp2 a[6], b[6], c[6];  // f_i l0, f_i l1, f_i l3
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    a[i] = f2_mul_fp(f.c[i], l0);
    b[i] = f2_mul(f.c[i], l1);
    c[i] = f2_mul(f.c[i], l3);
  }
  Fp12 r;
  r.c[0] = f2_add(a[0], f2_mul_xi(f2_add(b[5], c[3])));
  r.c[1] = f2_add(f2_add(a[1], b[0]), f2_mul_xi(c[4]));
  r.c[2] = f2_add(f2_add(a[2], b[1]), f2_mul_xi(c[5]));
  r.c[3] = f2_add(f2_add(a[3], b[2]), c[0]);
  r.c[4] = f2_add(f2_add(a[4], b[3]), c[1]);
  r.c[5] = f2_add(f2_add(a[5], b[4]), c[2]);
  return r;
}

// a^(p^k), k = 1, 2, 3: conj^k of each coefficient, times gamma_k
__device__ __noinline__ Fp12 f12_frobenius(const Fp12 x, int k) {
  Fp12 r;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    Fp2 g;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      g.c0.v[w] = kGamma[k - 1][i][0][w];
      g.c1.v[w] = kGamma[k - 1][i][1][w];
    }
    r.c[i] = f2_mul(k % 2 ? f2_conj(x.c[i]) : x.c[i], g);
  }
  return r;
}

// Granger-Scott squaring (cyclotomic subgroup only): the pairs (c0, c3),
// (c1, c4), (c2, c5) are Fp4 = Fp2[t]/(t^2 - xi) elements; 18 Fp products
__device__ __forceinline__ void fp4_sqr(const Fp2& x, const Fp2& y, Fp2& e,
                                        Fp2& o) {
  const Fp2 x2 = f2_sqr(x), y2 = f2_sqr(y);
  e = f2_add(x2, f2_mul_xi(y2));
  o = f2_sub(f2_sub(f2_sqr(f2_add(x, y)), x2), y2);
}
__device__ __forceinline__ Fp2 three_minus_two(const Fp2& t, const Fp2& c) {
  return f2_sub(f2_add(f2_dbl(t), t), f2_dbl(c));
}
__device__ __forceinline__ Fp2 three_plus_two(const Fp2& t, const Fp2& c) {
  return f2_add(f2_add(f2_dbl(t), t), f2_dbl(c));
}
__device__ __noinline__ Fp12 f12_cyclotomic_sqr(const Fp12 a) {
  Fp2 t0, t1, t2, t3, t4, t5;
  fp4_sqr(a.c[0], a.c[3], t0, t1);
  fp4_sqr(a.c[1], a.c[4], t2, t3);
  fp4_sqr(a.c[2], a.c[5], t4, t5);
  return {{three_minus_two(t0, a.c[0]), three_plus_two(f2_mul_xi(t5), a.c[1]),
           three_minus_two(t2, a.c[2]), three_plus_two(t1, a.c[3]),
           three_minus_two(t4, a.c[4]), three_plus_two(t3, a.c[5])}};
}

// 1 / a: a conj(a) is even in w, an Fp6 element g0 + g1 v + g2 v^2 that
// inverts in closed form (pairing_jax.f12_inv); a^-1 = conj(a) g^-1
__device__ __noinline__ Fp12 f12_inv(const Fp12 a) {
  const Fp12 c = f12_conj(a);
  const Fp12 n = f12_mul(a, c);
  const Fp2 g0 = n.c[0], g1 = n.c[2], g2 = n.c[4];
  const Fp2 c0 = f2_sub(f2_sqr(g0), f2_mul_xi(f2_mul(g1, g2)));
  const Fp2 c1 = f2_sub(f2_mul_xi(f2_sqr(g2)), f2_mul(g0, g1));
  const Fp2 c2 = f2_sub(f2_sqr(g1), f2_mul(g0, g2));
  const Fp2 den = f2_add(f2_mul(g0, c0),
                         f2_mul_xi(f2_add(f2_mul(g2, c1), f2_mul(g1, c2))));
  const Fp2 di = f2_inv(den);
  const Fp2 z = F2::zero();
  const Fp12 ginv = {{f2_mul(c0, di), z, f2_mul(c1, di), z, f2_mul(c2, di),
                      z}};
  return f12_mul(c, ginv);
}

__device__ __forceinline__ Fp12 f12_load(const int64_t* p) {
  Fp12 r;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.c[i] = F2::load(p + 32 * i);
  return r;
}
__device__ __forceinline__ void f12_store(int64_t* p, const Fp12& a) {
#pragma unroll
  for (int i = 0; i < 6; ++i) F2::store(p + 32 * i, a.c[i]);
}

// ------------------------------------------------------------------ P1

// The kernel's parameters, by value: per leg the G1 point's rows, its 12
// line arrays in LineArrays order (dbl an0, an1, b0, b1; add ...; end ...)
// and their batch stride in limbs (0: one row a step shared by the batch,
// the arrays [S, 16]; 16: [S, B, 16]).
struct MillerArgs {
  const int64_t* px[kMaxLegs];
  const int64_t* py[kMaxLegs];
  const int64_t* line[kMaxLegs][12];
  long long stride[kMaxLegs];
  int legs;
  int batch;
};

// f times leg l's line at step s of part `part` (0 dbl, 4 add, 8 end).
__device__ __forceinline__ Fp12 line_step(const Fp12& f, const MillerArgs& a,
                                          int l, int part, int s, int b,
                                          const Fp& px, const Fp& py) {
  const long long st = a.stride[l];
  const long long off = s * (st ? (long long)a.batch * 16 : 16) + b * st;
  const Fp2 an = {fp_load(a.line[l][part] + off),
                  fp_load(a.line[l][part + 1] + off)};
  const Fp2 be = {fp_load(a.line[l][part + 2] + off),
                  fp_load(a.line[l][part + 3] + off)};
  return f12_mul_line(f, py, f2_mul_fp(an, px), be);
}

__global__ void __launch_bounds__(kPairThreads)
    k_miller_lines(const MillerArgs args, int64_t* out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= args.batch) return;
  Fp px[kMaxLegs], py[kMaxLegs];
  for (int l = 0; l < args.legs; ++l) {
    px[l] = fp_load(args.px[l] + 16 * b);
    py[l] = fp_load(args.py[l] + 16 * b);
  }
  Fp12 f = f12_one();
#pragma unroll 1
  for (int s = 0; s < kAteSteps; ++s) {
    f = f12_sqr(f);
#pragma unroll 1
    for (int l = 0; l < args.legs; ++l)
      f = line_step(f, args, l, 0, s, b, px[l], py[l]);
    if ((kAteBits >> (kAteSteps - 1 - s)) & 1) {
#pragma unroll 1
      for (int l = 0; l < args.legs; ++l)
        f = line_step(f, args, l, 4, s, b, px[l], py[l]);
    }
  }
#pragma unroll 1
  for (int i = 0; i < 2; ++i)
#pragma unroll 1
    for (int l = 0; l < args.legs; ++l)
      f = line_step(f, args, l, 8, i, b, px[l], py[l]);
  f12_store(out + 192 * (long long)b, f);
}

// ------------------------------------------------------------------ P2

// a^BN_X by cyclotomic squares from the bit after the leading one (a in
// the cyclotomic subgroup): FE_PROGRAM's pow_x
__device__ __noinline__ Fp12 f12_pow_x_cyclo(const Fp12 a) {
  Fp12 acc = a;
#pragma unroll 1
  for (int i = kBnXBits - 2; i >= 0; --i) {
    acc = f12_cyclotomic_sqr(acc);
    if ((kBnX >> i) & 1) acc = f12_mul(acc, a);
  }
  return acc;
}

__global__ void __launch_bounds__(kPairThreads)
    k_final_exp(const int64_t* f, int64_t* out, int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const Fp12 x = f12_load(f + 192 * (long long)b);
  // easy part: t = f^(p^6 - 1), m = t^(p^2) t
  const Fp12 t = f12_mul(f12_conj(x), f12_inv(x));
  const Fp12 m = f12_mul(f12_frobenius(t, 2), t);
  // x-power ladder
  const Fp12 fx = f12_pow_x_cyclo(m);
  const Fp12 fx2 = f12_pow_x_cyclo(fx);
  const Fp12 fx3 = f12_pow_x_cyclo(fx2);
  // y terms
  const Fp12 y0 = f12_mul(f12_mul(f12_frobenius(m, 1), f12_frobenius(m, 2)),
                          f12_frobenius(m, 3));
  const Fp12 y1 = f12_conj(m);
  const Fp12 y2 = f12_frobenius(fx2, 2);
  const Fp12 y3 = f12_conj(f12_frobenius(fx, 1));
  const Fp12 y4 = f12_conj(f12_mul(fx, f12_frobenius(fx2, 1)));
  const Fp12 y5 = f12_conj(fx2);
  const Fp12 y6 = f12_conj(f12_mul(fx3, f12_frobenius(fx3, 1)));
  // Scott et al. combine
  Fp12 t0 = f12_mul(f12_mul(f12_cyclotomic_sqr(y6), y4), y5);
  Fp12 t1 = f12_mul(f12_mul(y3, y5), t0);
  t0 = f12_mul(t0, y2);
  t1 = f12_cyclotomic_sqr(f12_mul(f12_cyclotomic_sqr(t1), t0));
  t0 = f12_mul(t1, y1);
  t1 = f12_mul(t1, y0);
  f12_store(out + 192 * (long long)b,
            f12_mul(f12_cyclotomic_sqr(t0), t1));
}

}  // namespace zk

extern "C" {

int miller_args_size() { return (int)sizeof(zk::MillerArgs); }

int miller_lines(const zk::MillerArgs* args, int64_t* out, void* stream) {
  if (args->legs < 1 || args->legs > zk::kMaxLegs || args->batch < 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (args->batch + zk::kPairThreads - 1) / zk::kPairThreads;
  zk::k_miller_lines<<<blocks, zk::kPairThreads, 0, (cudaStream_t)stream>>>(
      *args, out);
  return (int)cudaGetLastError();
}

int final_exp(const int64_t* f, int64_t* out, int batch, void* stream) {
  if (batch < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (batch + zk::kPairThreads - 1) / zk::kPairThreads;
  zk::k_final_exp<<<blocks, zk::kPairThreads, 0, (cudaStream_t)stream>>>(
      f, out, batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
