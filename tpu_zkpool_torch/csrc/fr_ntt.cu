// Kernels P4 and P5: the prover's H(X) = (UV - W)/t over BN254 Fr, for
// Hopper (sm_90a).
//
// They replace no pl.pallas_call. The JAX package compiles the whole H(X)
// computation into one XLA program, tpu_zkpool/groth16/prove_tpu.py
// _h_pipeline (l.239; above domain 2^20 the three programs of
// _h_pipeline_split, l.294), whose butterflies are the radix-2 stages of
// tpu_zkpool/groth16/domain.py forward (l.73, decimation in frequency) and
// inverse (l.91, decimation in time).
//
// P4 k_fr_pass: `count` consecutive radix-2 stages of one direction over P
// polynomials of n values, from half-width h_first (DIF: h_first, h_first/2,
// ...; DIT: h_first, 2 h_first, ...). The stages touch the index bits
// [lo, lo + count) only, so the 2^count values that agree on every other
// bit (a group, values base | j << lo) are a closed problem: one block
// loads a group into shared memory, runs the stages there with a
// __syncthreads between them, and writes it back. Butterfly u at position
// i, v at i + h, twiddle w = pw[k n / (2h)] with k = i mod h from one power
// table of omega or omega^-1:
//   DIF (forward):  u + v,      (u - v) w
//   DIT (inverse):  u + v w,    u - v w
// with optional fused steps, in this order:
//   bitrev       read position br(i) of the input (interpolate_natural's
//                gather; out of place only);
//   quotient     the read values become (y b - c) t, b and c read at the
//                same positions as y, t one value (the coset quotient, on
//                the first pass of the coset inverse: h_ev is never
//                written);
//   pre          the first stage's inputs times a per-element table (g^i);
//   post         the last stage's outputs times a per-element table (g^-i);
//   post_scalar  then times one value (n^-1, or n^-1 R^-1 with the
//                demont step folded in: mont_mul(x, n^-1) equals
//                mont_mul(mont_mul(x, n^-1 R), 1)).
// Every value is canonical and a field product exact, so the fused forms
// give the limbs of the plain version's separate steps (groth16/domain.py
// pass_plain: stage_plain `count` times).
//
// P5 k_fr_pointwise: a t per element of N, t one value (groth16/domain.py
// pointwise_plain): the R^2 step of the evaluations' upload, and the fused
// products of a transform of n = 1, which has no stage. The pipeline's
// quotient and demont step ride P4's passes.
//
// Bound. A transform of n = 2^L is ceil(L / 11) passes (groth16/domain.py
// pass_plan: 2^21 11 + 10 stages, 2^14 7 + 7), each reading and writing
// its P n values once and doing count n/2 products (264 32-bit
// multiply-adds each). At 2^21, P = 1: 21 x 2^20 products = 0.35 ms at
// 132 SMs x 64 lanes x 1,980 MHz, against 2 x 512 MiB of int64 limbs =
// 0.32 ms at 3.35 TB/s: two passes make the products the bound, which is
// why global storage stays the port's int64 16-bit limbs (128 B a value;
// domain.* and the H leg's MSM scalars keep their layout) and only the
// tile in shared memory is packed. Each stage-a-launch form moved the whole
// array 21 times (8 ms a 2^21 transform).
//
// Design. Global moves are warp-cooperative: 8 threads a value, each one
// 16-byte longlong2 (limbs 2w, 2w + 1 = word w), so a warp instruction
// moves four whole 128-byte values, converted to words on the way into
// shared memory and back on the way out; four moves in flight a thread.
// The tile is word-major, word w of value j at w (2^count + 4) + (j ^ 31
// when bit 5 of j is set): a stage's 32 u (or v) reads of a warp fall in
// 32 distinct banks at every half-width (bit s of j fixed, s < 5, leaves 16
// residues mod 32, and the flip of bit 5's half sends the other 16 to the
// complement), and the 4-word pad puts the 8 words of a warp's 4 values of
// a move in 32 banks. A tile of 2^11 values is 64 KiB + 128 B (three
// blocks a SM), the quotient's chunked staging of b and c 16 KiB more.
// Twiddles and the per-element tables are read as packed words (32 B a
// value, built on the device in domain.tables from its int64 rows): a
// group reads 2^count - 1 distinct twiddles for its 2^count values, so a
// pass reads at most a quarter of its data bytes in twiddles, and at 2^21
// the table is 32 MiB where the int64 rows are 128 MiB (the two-level
// table w^(a+b) = w^a w^b would cost a product a twiddle on a
// product-bound pass). Products are field.cuh's PTX carry-chain row, and
// the pass asks for three blocks a SM (__launch_bounds__(kFrBlock, 3):
// three tiles of 11 stages fit a SM's shared memory), which beat the C row
// at two blocks a SM (PERF.md). kFrTileLog is a compile-time constant,
// which the library exports (fr_max_pass) for the pass plan: the host
// build sets it small (-DZK_FR_TILE_LOG=3) so that tiny transforms run as
// several passes.
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/groth16/ntt_kernels.py); returns cudaGetLastError().

#ifndef ZK_HOST_TEST
#include <cuda_runtime.h>
#endif

#include <cstdint>

#include "field.cuh"

#ifndef ZK_FR_TILE_LOG
#define ZK_FR_TILE_LOG 11
#endif

namespace zk {

constexpr int kFrBlock = 256;              // P5's block; P4's most threads
constexpr int kFrMaxLogN = 28;             // Fr - 1 = 2^28 * odd
constexpr int kFrTileLog = ZK_FR_TILE_LOG;  // most stages a pass (fr_max_pass)
constexpr int kFrPad = 4;                  // words after each tile row
constexpr int kFrMoves = 4;                // global moves in flight a thread
// P4's dynamic shared words at most: the tile and the quotient's staging
constexpr int kFrPassWords =
    8 * ((1 << kFrTileLog) + kFrPad) + 16 * (kFrBlock + kFrPad);

struct FrPassArgs {
  const int64_t* y;            // (P, n, 16)
  int64_t* out;                // (P, n, 16); may be y unless bitrev
  const uint4* pw;             // (n/2, 8) words: powers of omega or omega^-1
  const uint4* pre;            // (n, 8) words or null
  const uint4* post;           // (n, 8) words or null
  const int64_t* post_scalar;  // (16) or null
  const int64_t* qb;           // (P, n, 16) or null: the quotient's b,
  const int64_t* qc;           // c (P, n, 16)
  const int64_t* qt;           // and t (16)
  long long P;
  int log_n, lo, count;        // the stages touch index bits [lo, lo+count)
  int dif, bitrev;
};

struct FrPointwiseArgs {
  const int64_t* a;  // (N, 16)
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

// The products of P4 and P5: field.cuh's PTX carry-chain row (kRowPtx),
// inlined.
__device__ __forceinline__ Fr fr_pmul(const Fr& a, const Fr& b) {
  Fr r;
  mont_mul_n<FrMod, kRowPtx, 1>(&r, &a, &b);
  return r;
}

// One value of a packed word table (two uint4, 32 B).
__device__ __forceinline__ Fr fr_words(const uint4* p) {
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  return Fr{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
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

// The global position of a group's value q: base | q << lo, read in
// bit-reversed order (over `bits`) if br.
struct FrPos {
  long long base;
  int lo, bits, br;
  __device__ __forceinline__ long long operator()(int q) const {
    const long long i = base | ((long long)q << lo);
    return br ? bit_reverse(i, bits) : i;
  }
};

// Tile row of value j (word w at w * stride + fr_swz(j)).
__device__ __forceinline__ int fr_swz(int j) {
  return j ^ (-((j >> 5) & 1) & 31);
}

__device__ __forceinline__ Fr tile_get(const uint32_t* s, int st, int j) {
  const int p = fr_swz(j);
  Fr r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = s[i * st + p];
  return r;
}

__device__ __forceinline__ void tile_put(uint32_t* s, int st, int j,
                                         const Fr& a) {
  const int p = fr_swz(j);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i * st + p] = a.v[i];
}

// Values q0 .. q0 + m - 1 of `pos` (int64 limbs at src + 16 pos(q)) into
// tile rows 0 .. m - 1: 8 threads a value, one longlong2 (a word) each.
__device__ __forceinline__ void tile_load(uint32_t* s, int st,
                                          const int64_t* src,
                                          const FrPos& pos, int q0, int m) {
  const int T = blockDim.x, end = 8 * m;
  for (int e0 = threadIdx.x; e0 < end; e0 += kFrMoves * T) {
    longlong2 l[kFrMoves];
#pragma unroll
    for (int r = 0; r < kFrMoves; ++r) {
      const int e = e0 + r * T;
      if (e < end)
        l[r] = reinterpret_cast<const longlong2*>(
            src + 16 * pos(q0 + (e >> 3)))[e & 7];
    }
#pragma unroll
    for (int r = 0; r < kFrMoves; ++r) {
      const int e = e0 + r * T;
      if (e < end)
        s[(e & 7) * st + fr_swz(e >> 3)] =
            (uint32_t)l[r].x | ((uint32_t)l[r].y << 16);
    }
  }
}

// Tile rows 0 .. m - 1 out to int64 limbs at dst + 16 pos(q).
__device__ __forceinline__ void tile_store(int64_t* dst, const uint32_t* s,
                                           int st, const FrPos& pos, int m) {
  for (int e = threadIdx.x; e < 8 * m; e += blockDim.x) {
    const uint32_t v = s[(e & 7) * st + fr_swz(e >> 3)];
    reinterpret_cast<longlong2*>(dst + 16 * pos(e >> 3))[e & 7] =
        make_longlong2(v & 0xFFFFu, v >> 16);
  }
}

// The quotient prologue: tile value j becomes (y b - c) t, b and c staged
// through shared memory a chunk of blockDim values at a time.
__device__ __forceinline__ void fr_quotient(uint32_t* tile, int st,
                                            uint32_t* scratch,
                                            const FrPassArgs& a,
                                            long long row, const FrPos& pos,
                                            int m) {
  const int T = blockDim.x, cs = T + kFrPad;
  uint32_t* sb = scratch;
  uint32_t* sc = scratch + 8 * cs;
  const Fr t = fr_load2(a.qt);
  for (int c0 = 0; c0 < m; c0 += T) {
    const int cm = min(T, m - c0);
    tile_load(sb, cs, a.qb + row, pos, c0, cm);
    tile_load(sc, cs, a.qc + row, pos, c0, cm);
    __syncthreads();  // the chunk and the tile are in
    const int q = threadIdx.x;
    if (q < cm) {
      const Fr x = fr_pmul(tile_get(tile, st, c0 + q), tile_get(sb, cs, q));
      tile_put(tile, st, c0 + q,
               fr_pmul(mont_sub(x, tile_get(sc, cs, q)), t));
    }
    __syncthreads();  // before the next chunk overwrites the staging
  }
}

__global__ void __launch_bounds__(kFrBlock, 3)
    k_fr_pass(const FrPassArgs a) {
  ZK_DYNAMIC_SHARED(uint32_t, sm, kFrPassWords);
  const int c = a.count, m = 1 << c, st = m + kFrPad, gl = a.log_n - c;
  const long long poly = (long long)blockIdx.x >> gl;
  const long long g = (long long)blockIdx.x & ((1LL << gl) - 1);
  const long long low = g & ((1LL << a.lo) - 1);
  const long long base = ((g >> a.lo) << (a.lo + c)) | low;
  const long long row = poly << (a.log_n + 4);  // the polynomial's limbs
  const FrPos src{base, a.lo, a.log_n, a.bitrev};
  tile_load(sm, st, a.y + row, src, 0, m);
  if (a.qb) fr_quotient(sm, st, sm + 8 * st, a, row, src, m);
  __syncthreads();
  for (int t = 0; t < c; ++t) {
    const int sl = a.dif ? c - 1 - t : t;  // the stage's bit in the group
    const int s = a.lo + sl, hl = 1 << sl;
    const bool pre = t == 0 && a.pre, last = t == c - 1;
    for (int b = threadIdx.x; b < m / 2; b += blockDim.x) {
      const int ju = ((b >> sl) << (sl + 1)) | (b & (hl - 1)), jv = ju + hl;
      const long long iu = base | ((long long)ju << a.lo);
      const long long iv = iu + (1LL << s);
      Fr u = tile_get(sm, st, ju), v = tile_get(sm, st, jv);
      const long long k = iu & ((1LL << s) - 1);
      const Fr w = fr_words(a.pw + 2 * (k << (a.log_n - 1 - s)));
      if (pre) {
        u = fr_pmul(u, fr_words(a.pre + 2 * iu));
        v = fr_pmul(v, fr_words(a.pre + 2 * iv));
      }
      Fr x0, x1;
      if (a.dif) {
        x0 = mont_add(u, v);
        x1 = fr_pmul(mont_sub(u, v), w);
      } else {
        const Fr vw = fr_pmul(v, w);
        x0 = mont_add(u, vw);
        x1 = mont_sub(u, vw);
      }
      if (last && a.post) {
        x0 = fr_pmul(x0, fr_words(a.post + 2 * iu));
        x1 = fr_pmul(x1, fr_words(a.post + 2 * iv));
      }
      if (last && a.post_scalar) {
        const Fr sc = fr_load2(a.post_scalar);
        x0 = fr_pmul(x0, sc);
        x1 = fr_pmul(x1, sc);
      }
      tile_put(sm, st, ju, x0);
      tile_put(sm, st, jv, x1);
    }
    __syncthreads();
  }
  tile_store(a.out + row, sm, st, FrPos{base, a.lo, a.log_n, 0}, m);
}

__global__ void __launch_bounds__(kFrBlock)
    k_fr_pointwise(const FrPointwiseArgs a) {
  constexpr int st = kFrBlock + kFrPad;
  __shared__ uint32_t sa[8 * st];
  const long long v0 = (long long)blockIdx.x * kFrBlock;
  const int m = a.N - v0 < kFrBlock ? (int)(a.N - v0) : kFrBlock;
  const FrPos pos{v0, 0, 1, 0};  // v0 | q: v0 is a multiple of kFrBlock
  tile_load(sa, st, a.a, pos, 0, m);
  __syncthreads();
  const int q = threadIdx.x;
  if (q < m) tile_put(sa, st, q, fr_pmul(tile_get(sa, st, q), fr_load2(a.t)));
  __syncthreads();
  tile_store(a.out, sa, st, pos, m);
}

// P4's launch: a block a group (P 2^(log_n - count) blocks), at most
// kFrBlock threads and at least a warp, the tile (and with the quotient its
// staging) in dynamic shared memory. False if the arguments are invalid.
inline bool fr_pass_shape(const FrPassArgs& a, long long* blocks,
                          int* threads, int* smem) {
  const int c = a.count;
  if (a.P < 1 || a.log_n < 1 || a.log_n > kFrMaxLogN || c < 1 ||
      c > kFrTileLog || a.lo < 0 || a.lo + c > a.log_n ||
      (a.bitrev && a.y == a.out) || (a.qb == nullptr) != (a.qc == nullptr) ||
      (a.qb == nullptr) != (a.qt == nullptr))
    return false;
  *blocks = a.P << (a.log_n - c);
  *threads = c > 8 ? kFrBlock : c > 6 ? 1 << (c - 1) : 32;
  *smem = 4 * (8 * ((1 << c) + kFrPad) +
               (a.qb ? 16 * (*threads + kFrPad) : 0));
  return *blocks <= 0x7fffffffLL;
}

}  // namespace zk

extern "C" {

// The most stages a P4 launch runs: the tile this library was built with.
int fr_max_pass() { return zk::kFrTileLog; }

// P4 over (P, n = 2^log_n, 16) values: `count` stages from half-width
// 2^log_h of direction `dif`. pw, pre, post are packed words (8 a value);
// pre, post, post_scalar may be null; qb, qc, qt all null or all set (the
// quotient). Every pointer 16-byte aligned.
int fr_pass(const int64_t* y, int64_t* out, const void* pw, const void* pre,
            const void* post, const int64_t* post_scalar, const int64_t* qb,
            const int64_t* qc, const int64_t* qt, long long P, int log_n,
            int log_h, int count, int dif, int bitrev, void* stream) {
  const int lo = dif ? log_h - count + 1 : log_h;
  if (log_h < 0 || log_h >= log_n) return (int)cudaErrorInvalidValue;
  const zk::FrPassArgs a{y, out, (const uint4*)pw, (const uint4*)pre,
                         (const uint4*)post, post_scalar, qb, qc, qt, P,
                         log_n, lo, count, dif != 0, bitrev != 0};
  long long blocks;
  int threads, smem;
  if (!zk::fr_pass_shape(a, &blocks, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  // above 48 KB the kernel's opt-in, once a device (so not inside a graph
  // capture that follows a warm call)
  static bool opted[64] = {};
  int dev = 0;
  if (smem > 48 * 1024 && (cudaGetDevice(&dev) != cudaSuccess || dev >= 64 ||
                           !opted[dev])) {
    const cudaError_t rc = cudaFuncSetAttribute(
        zk::k_fr_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
        4 * zk::kFrPassWords);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) opted[dev] = true;
  }
  zk::k_fr_pass<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// P5 over N values: out = a t.
int fr_pointwise(const int64_t* a, const int64_t* t, int64_t* out,
                 long long N, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (N + zk::kFrBlock - 1) / zk::kFrBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const zk::FrPointwiseArgs args{a, t, out, N};
  zk::k_fr_pointwise<<<(unsigned)blocks, zk::kFrBlock, 0,
                       (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // extern "C"
