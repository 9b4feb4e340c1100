// Kernels P4 and P5: the prover's H(X) = (UV - W)/t over BN254 Fr, for
// Hopper (sm_90a).
//
// They replace no pl.pallas_call. The JAX package compiles the whole H(X)
// computation into one XLA program, tpu_zkpool/groth16/prove_tpu.py
// _h_pipeline (l.238; above domain 2^20 the three programs _h_interp_coset,
// _h_combine and _h_final), whose butterflies are the radix-2 stages of
// tpu_zkpool/groth16/domain.py forward (l.73, decimation in frequency) and
// inverse (l.91, decimation in time). The port ran the same steps as
// FieldCtx torch ops, dozens of launches a Montgomery product and
// thousands a domain-2^14 pipeline: launch-bound on the card. Here a stage
// is one launch (P4) and each element-wise step outside the stages is one
// launch (P5).
//
// P4 k_fr_stage: one radix-2 stage of half-width h over P polynomials of
// n values, one thread a butterfly (u at position i, v at i + h, k = i mod
// h, twiddle w = pw[k * n / (2h)] from one Montgomery power table of omega
// or omega^-1, (n/2, 16) rows):
//   DIF (forward):  u + v,      (u - v) w
//   DIT (inverse):  u + v w,    u - v w
// with optional fused steps, in this order:
//   bitrev       read position br(i) of the input (interpolate_natural's
//                gather; only out of place);
//   pre          u, v times a per-element table (the coset powers g^i);
//   post         both outputs times a per-element table (g^-i);
//   post_scalar  both outputs times one value (n^-1).
// Every value is canonical, and a field product is exact, so fused
// products give the limbs of the plain version's separate ones
// (groth16/domain.py stage_plain).
//
// P5 k_fr_pointwise: per element of N, with t one value:
//   mode mul       a t                 (R^2: into Montgomery form; 1: out)
//   mode quotient  (a b - c) t         (the coset quotient, t = t(g)^-1)
// (groth16/domain.py pointwise_plain). The per-element tables of the
// pipeline (g^i, g^-i) ride P4's first and last stages instead.
//
// Bound: bytes. A stage reads and writes each of its P n values once (256
// B a butterfly in the port's int64 16-bit limb storage) and does one
// Montgomery product a butterfly (264 32-bit multiply-adds); the card moves
// 3.35 TB/s and issues ~16.7 T multiply-adds/s, so the bytes take ~5x the
// products' time even with every fused product on. P5 likewise. So the
// design is the plain one: a thread loads its two values as 16-byte
// longlong2 moves (limbs 2j and 2j + 1 are word j), neighbouring threads
// on neighbouring values from h >= 2 on; a stage whose butterflies span
// the whole array (h = n/2) is the same launch. Fusing the stages whose
// butterflies stay inside one block's shared memory, and packed 32-bit
// storage, would cut the bytes; they are not done here.
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/groth16/ntt_kernels.py); returns cudaGetLastError().

#ifndef ZK_HOST_TEST
#include <cuda_runtime.h>
#endif

#include <cstdint>

#include "field.cuh"

namespace zk {

constexpr int kFrBlock = 256;
constexpr int kFrMaxLogN = 28;  // Fr - 1 = 2^28 * odd

struct FrStageArgs {
  const int64_t* y;            // (P, n, 16)
  int64_t* out;                // (P, n, 16); may be y unless bitrev
  const int64_t* pw;           // (n/2, 16) powers of omega or omega^-1
  const int64_t* pre;          // (n, 16) or null
  const int64_t* post;         // (n, 16) or null
  const int64_t* post_scalar;  // (16) or null
  long long P;
  int log_n, log_h;
  int dif, bitrev;
};

struct FrPointwiseArgs {
  const int64_t* a;  // (N, 16)
  const int64_t* b;  // (N, 16), null in mode mul
  const int64_t* c;  // (N, 16), null in mode mul
  const int64_t* t;  // (16)
  int64_t* out;      // (N, 16); may be a
  long long N;
};

__device__ __forceinline__ Fr fr_load2(const int64_t* p) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
  Fr r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const longlong2 w = q[i];
    r.v[i] = (uint32_t)w.x | ((uint32_t)w.y << 16);
  }
  return r;
}

__device__ __forceinline__ void fr_store2(int64_t* p, const Fr& a) {
  longlong2* q = reinterpret_cast<longlong2*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    q[i] = make_longlong2(a.v[i] & 0xFFFFu, a.v[i] >> 16);
}

// The low `bits` bits of x reversed (bits >= 1).
__device__ __forceinline__ long long bit_reverse(long long x, int bits) {
#ifdef ZK_HOST_TEST
  uint32_t r = 0;
  for (int b = 0; b < 32; ++b) r |= (((uint32_t)x >> b) & 1u) << (31 - b);
#else
  const uint32_t r = __brev((uint32_t)x);
#endif
  return (long long)(r >> (32 - bits));
}

__global__ void __launch_bounds__(kFrBlock) k_fr_stage(const FrStageArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lh = a.log_h;
  const long long half = 1LL << (a.log_n - 1);
  if (t >= a.P * half) return;
  const long long j = t & (half - 1);
  const long long k = j & ((1LL << lh) - 1);
  const long long iu = ((j >> lh) << (lh + 1)) | k;
  const long long iv = iu + (1LL << lh);
  const long long row = (t >> (a.log_n - 1)) << (a.log_n + 4);
  const int64_t* y = a.y + row;
  long long su = iu, sv = iv;
  if (a.bitrev) {
    su = bit_reverse(iu, a.log_n);
    sv = bit_reverse(iv, a.log_n);
  }
  Fr u = fr_load2(y + su * 16), v = fr_load2(y + sv * 16);
  if (a.pre) {
    u = mont_mul(u, fr_load2(a.pre + iu * 16));
    v = mont_mul(v, fr_load2(a.pre + iv * 16));
  }
  const Fr w = fr_load2(a.pw + (k << (a.log_n - 1 - lh)) * 16);
  Fr x0, x1;
  if (a.dif) {
    x0 = mont_add(u, v);
    x1 = mont_mul(mont_sub(u, v), w);
  } else {
    const Fr vw = mont_mul(v, w);
    x0 = mont_add(u, vw);
    x1 = mont_sub(u, vw);
  }
  if (a.post) {
    x0 = mont_mul(x0, fr_load2(a.post + iu * 16));
    x1 = mont_mul(x1, fr_load2(a.post + iv * 16));
  }
  if (a.post_scalar) {
    const Fr s = fr_load2(a.post_scalar);
    x0 = mont_mul(x0, s);
    x1 = mont_mul(x1, s);
  }
  fr_store2(a.out + row + iu * 16, x0);
  fr_store2(a.out + row + iv * 16, x1);
}

__global__ void __launch_bounds__(kFrBlock)
    k_fr_pointwise(const FrPointwiseArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.N) return;
  Fr x = fr_load2(a.a + i * 16);
  if (a.b) x = mont_sub(mont_mul(x, fr_load2(a.b + i * 16)),
                        fr_load2(a.c + i * 16));
  x = mont_mul(x, fr_load2(a.t));
  fr_store2(a.out + i * 16, x);
}

inline long long fr_stage_threads(const FrStageArgs& a) {
  return a.P << (a.log_n - 1);
}

}  // namespace zk

extern "C" {

// P4 over (P, n = 2^log_n, 16) values, half-width 2^log_h. Every pointer
// 16-byte aligned; pre, post, post_scalar may be null.
int fr_stage(const int64_t* y, int64_t* out, const int64_t* pw,
             const int64_t* pre, const int64_t* post,
             const int64_t* post_scalar, long long P, int log_n, int log_h,
             int dif, int bitrev, void* stream) {
  if (P < 1 || log_n < 1 || log_n > zk::kFrMaxLogN || log_h < 0 ||
      log_h >= log_n || (bitrev && y == out))
    return (int)cudaErrorInvalidValue;
  const zk::FrStageArgs a{y, out, pw, pre, post, post_scalar, P,
                          log_n, log_h, dif != 0, bitrev != 0};
  const long long threads = zk::fr_stage_threads(a);
  const long long blocks = (threads + zk::kFrBlock - 1) / zk::kFrBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  zk::k_fr_stage<<<(unsigned)blocks, zk::kFrBlock, 0,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// P5 over N values; b and c both null (mode mul) or both set (quotient).
int fr_pointwise(const int64_t* a, const int64_t* b, const int64_t* c,
                 const int64_t* t, int64_t* out, long long N, void* stream) {
  if (N < 1 || (b == nullptr) != (c == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (N + zk::kFrBlock - 1) / zk::kFrBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const zk::FrPointwiseArgs args{a, b, c, t, out, N};
  zk::k_fr_pointwise<<<(unsigned)blocks, zk::kFrBlock, 0,
                       (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // extern "C"
