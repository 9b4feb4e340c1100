// The product-latency microbenchmark of chip_smoke.py (phase 2): one thread
// walks a dependent chain x = x * y of n Montgomery products, in Fp or Fp2,
// in one of five forms:
//   0 (a) the out-of-line fp_mul (Fp2Field::mul: three calls in sequence),
//         what K1, K3-K5, K7 and K8 run;
//   1 (b) the same CIOS inlined (mont_mul_n, 64-bit C accumulators);
//   2 (c) the CIOS inlined with PTX carry chains (mad.lo.cc, madc.hi.cc,
//         addc);
//   3 (d) three independent chains interleaved in one thread, form (b);
//   4 (d) the same, form (c);
//   5 (e) fp_mul_fast, form (c) out of line: the product K2 runs;
//   6 (f) three chains, one a lane of one warp (FpWarp / Fp2Warp::muls<3>:
//         lane i computes product i, shuffles hand every lane all three):
//         one dependency level of K6;
//   7 (g) one chain, each product spread over K = 4 lanes (lanes.cuh:
//         split_mul), Fp only;
//   8 (g) the same over K = 8 lanes.
// Every latency-bound kernel pays this figure: K6 and K2 on the prover's
// path, K8's tree levels and K7's narrow levels off it. The kernel reads
// three (x, y) pairs, runs `n` steps, writes the three x (one chain's
// forms write their x three times) and the clock64 cycles of the loop; the
// caller times the launch with CUDA events and checks that every form ends
// on the same limbs.
//
// The inverse microbenchmark (inv_chain): one thread walks a dependent
// chain of n inversions x <- x^-1 + y over Fp in one of three forms, (i)
// fp_inv_fermat and (ii) fp_inv_window below, (iii) field.cuh's fp_inv
// (safegcd, the form K8 runs), and, forms 3 and 4, a chain of n squares x
// <- x^2 by fp_mul(x, x) and by the dedicated fp_sqr. The caller holds
// forms 1-2 to form 0's limbs and form 4 to form 3's; K8 pays one
// inversion a block, K7 two squares and a product an S-box.
//
// Interface: plain C, launched <<<1, 1>>> (forms 6-8: <<<1, 32>>>) on the
// caller's stream; returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "field.cuh"
#include "lanes.cuh"

namespace zk {

// r[k] = a[k] b[k] in Fp2, k < N: Fp2Field::mul's Karatsuba, its 3 N Fp
// products issued together through mont_mul_n.
template <int FORM, int N>
__device__ __forceinline__ void fp2_mul_n(Fp2* r, const Fp2* a, const Fp2* b) {
  Fp x[3 * N], y[3 * N], t[3 * N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[3 * k] = a[k].c0;
    x[3 * k + 1] = a[k].c1;
    x[3 * k + 2] = fp_add(a[k].c0, a[k].c1);
    y[3 * k] = b[k].c0;
    y[3 * k + 1] = b[k].c1;
    y[3 * k + 2] = fp_add(b[k].c0, b[k].c1);
  }
  mont_mul_n<FpMod, FORM, 3 * N>(t, x, y);
#pragma unroll
  for (int k = 0; k < N; ++k)
    r[k] = {fp_sub(t[3 * k], t[3 * k + 1]),
            fp_sub(fp_sub(t[3 * k + 2], t[3 * k]), t[3 * k + 1])};
}

// in (3, 2, NC, 16): pairs (x_k, y_k); out (3, NC, 16); cycles (1,).
template <int FORM, int NC>
__global__ void k_mul_chain(const int64_t* __restrict__ in,
                            int64_t* __restrict__ out,
                            long long* __restrict__ cycles, int n) {
  using T = typename std::conditional<NC == 1, Fp, Fp2>::type;
  using F = typename std::conditional<NC == 1, FpField, Fp2Field>::type;
  using FF = typename std::conditional<NC == 1, FpFieldFast,
                                       Fp2FieldFast>::type;
  using FW = typename std::conditional<NC == 1, FpWarp, Fp2Warp>::type;
  constexpr int E = NC * 16;
  constexpr int CH = FORM == 3 || FORM == 4 || FORM == 6 ? 3 : 1;
  constexpr int ROW = FORM == 2 || FORM == 4 ? kRowPtx : kRowC;
  T x[3], y[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = F::load(in + (2 * k) * E);
    y[k] = F::load(in + (2 * k + 1) * E);
  }
  long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if constexpr (FORM == 0) {
      x[0] = F::mul(x[0], y[0]);
    } else if constexpr (FORM == 5) {
      x[0] = FF::mul(x[0], y[0]);
    } else if constexpr (FORM == 6) {
      FW::template muls<3>(x, x, y);
    } else if constexpr (NC == 1) {
      mont_mul_n<FpMod, ROW, CH>(x, x, y);
    } else {
      fp2_mul_n<ROW, CH>(x, x, y);
    }
  }
  long long t1 = clock64();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) F::store(out + k * E, x[CH == 3 ? k : 0]);
  cycles[0] = t1 - t0;
}

// Form (g): every group of K lanes of one warp walks the chain x = x y of
// the first pair, K lanes a product (lanes.cuh: split_mul). in (3, 2, 1,
// 16); out (3, 1, 16).
template <int K>
__global__ void k_mul_lanes(const int64_t* __restrict__ in,
                            int64_t* __restrict__ out,
                            long long* __restrict__ cycles, int n) {
  using S = Split<FpMod, K>;
  constexpr int W = S::W;
  const int q = threadIdx.x & (K - 1);
  const Fp x0 = fp_load(in), y0 = fp_load(in + 16);
  S x, y;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j / W == q) {
      x.v[j % W] = x0.v[j];
      y.v[j % W] = y0.v[j];
    }
  const S p = split_modulus<FpMod, K>();
  long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = split_mul(x, y, p);
  long long t1 = clock64();
  Fp r;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    r.v[j] = __shfl_sync(0xffffffffu, x.v[j % W], j / W);
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) fp_store(out + k * 16, r);
  cycles[0] = t1 - t0;
}

// Form (i): a^(p-2) by square-and-multiply from bit 253 down: 253
// squarings and 109 products, each the out-of-line fp_mul (K8's inverse
// before safegcd). p's low word is odd and above 2, so only word 0 of p - 2
// differs from p's.
__device__ Fp fp_inv_fermat(const Fp& a) {
  Fp acc = a;
  for (int i = 252; i >= 0; --i) {
    acc = fp_mul(acc, acc);
    uint32_t w = kP[i >> 5] - (i < 32 ? 2u : 0u);
    if ((w >> (i & 31)) & 1u) acc = fp_mul(acc, a);
  }
  return acc;
}

// Form (ii): a^(p-2) by a fixed 4-bit window: a^0 .. a^15 (14 products),
// then for each of the 63 lower digits four dedicated squares and one
// product by the digit's power (none for a zero digit of the public
// exponent): 252 squares and 14 + 63 - (zero digits) products.
__device__ Fp fp_inv_window(const Fp& a) {
  Fp tab[16];
  tab[0] = fp_one();
  tab[1] = a;
  for (int i = 2; i < 16; ++i) tab[i] = fp_mul(tab[i - 1], a);
  auto digit = [](int d) {
    uint32_t w = kP[d >> 3] - (d < 8 ? 2u : 0u);
    return (int)((w >> (4 * (d & 7))) & 15u);
  };
  Fp acc = tab[digit(63)];
  for (int d = 62; d >= 0; --d) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = fp_sqr(acc);
    const int e = digit(d);
    if (e) acc = fp_mul(acc, tab[e]);
  }
  return acc;
}

// in (2, 16): x, y; out (16,); cycles (1,).
template <int FORM>
__global__ void k_inv_chain(const int64_t* __restrict__ in,
                            int64_t* __restrict__ out,
                            long long* __restrict__ cycles, int n) {
  Fp x = fp_load(in), y = fp_load(in + 16);
  long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if constexpr (FORM == 0) {
      x = fp_add(fp_inv_fermat(x), y);
    } else if constexpr (FORM == 1) {
      x = fp_add(fp_inv_window(x), y);
    } else if constexpr (FORM == 2) {
      x = fp_add(fp_inv(x), y);
    } else if constexpr (FORM == 3) {
      x = fp_mul(x, x);
    } else {
      x = fp_sqr(x);
    }
  }
  long long t1 = clock64();
  fp_store(out, x);
  cycles[0] = t1 - t0;
}

}  // namespace zk

extern "C" {

int inv_chain(const int64_t* in, int64_t* out, long long* cycles, int n,
              int form, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case 0: zk::k_inv_chain<0><<<1, 1, 0, s>>>(in, out, cycles, n); break;
    case 1: zk::k_inv_chain<1><<<1, 1, 0, s>>>(in, out, cycles, n); break;
    case 2: zk::k_inv_chain<2><<<1, 1, 0, s>>>(in, out, cycles, n); break;
    case 3: zk::k_inv_chain<3><<<1, 1, 0, s>>>(in, out, cycles, n); break;
    case 4: zk::k_inv_chain<4><<<1, 1, 0, s>>>(in, out, cycles, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int mul_chain(const int64_t* in, int64_t* out, long long* cycles, int n,
              int ncomp, int form, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define ZK_CHAIN(F_, NC_) \
  zk::k_mul_chain<F_, NC_><<<1, F_ == 6 ? 32 : 1, 0, s>>>(in, out, cycles, n)
#define ZK_FORMS(NC_)               \
  switch (form) {                   \
    case 0: ZK_CHAIN(0, NC_); break; \
    case 1: ZK_CHAIN(1, NC_); break; \
    case 2: ZK_CHAIN(2, NC_); break; \
    case 3: ZK_CHAIN(3, NC_); break; \
    case 4: ZK_CHAIN(4, NC_); break; \
    case 5: ZK_CHAIN(5, NC_); break; \
    case 6: ZK_CHAIN(6, NC_); break; \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (form == 7 || form == 8) {  // Fp only
    if (ncomp != 1) return (int)cudaErrorInvalidValue;
    if (form == 7)
      zk::k_mul_lanes<4><<<1, 32, 0, s>>>(in, out, cycles, n);
    else
      zk::k_mul_lanes<8><<<1, 32, 0, s>>>(in, out, cycles, n);
  } else if (ncomp == 1) {
    ZK_FORMS(1)
  } else {
    ZK_FORMS(2)
  }
#undef ZK_FORMS
#undef ZK_CHAIN
  return (int)cudaGetLastError();
}

}  // extern "C"
