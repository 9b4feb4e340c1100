// Kernel K8: one level of the batched-affine bucket tree for Hopper
// (sm_90a): M independent affine pair additions L + R over BN254 Fp, every
// lambda denominator inverted by Montgomery's batch trick.
//
// Replaces the Pallas kernel tpu_zkpool/msm/affine_tree.py
// _make_tree_kernel / _chunk_call (driven by tree_level_pallas). It
// computes what tree_level_xla computes, for every row, flagged rows
// included: d = xR - xL; in complete mode a pair with xL = xR and yL = yR
// doubles (den = 2 yL, num = 3 xL^2), else den = d, num = yR - yL; a zero
// denominator or an infinity operand substitutes den = 1; lambda = num / den,
// x3 = lambda^2 - xL - xR, y3 = lambda (xL - x3) - yL; an infinity operand
// passes the other one through, and the flag out is (INF_L and INF_R) or,
// for finite operands, xL = xR (complete mode: and yL != yR). Batch
// inversion yields each exact inverse, so no TPU chunking is copied.
//
// Design. A block of nt threads (32 or 128; any power of two up to 128
// runs) owns nt * per consecutive pairs, thread t the pairs t, t + nt, ...
// (per <= 8; neighbouring threads read neighbouring rows, 16 bytes a
// load). The wrapper (msm/tree_kernels.py:launch_shape) picks nt and per
// from M: about four resident blocks a SM at the prover's level 0 (163,840
// pairs: 128 threads, 3 pairs each, 427 blocks), and for narrow levels one
// pair a thread in 32-thread blocks, so a launch's latency is the inverse
// plus the tree. Forward: each thread forms its denominators and their running
// products P_j (P_0 .. P_{per-2} in dynamic shared memory, the total in a
// register). Mid: a product tree over the threads' totals in shared memory
// (log2 nt levels), one inversion of the block total by thread 0 with
// field.cuh's constant-time safegcd fp_inv (a Fermat chain, 362 dependent
// products in one thread, took ~0.25 ms on the H100, a floor under every
// launch), and a down-sweep that computes each level's two children on two
// threads (log2 nt levels), handing each thread the inverse S of its chain
// total.
// Backward: each thread walks its pairs from last to first, dinv = S
// P_{j-1} and S <- S den_j, then lambda, x3, y3 and the selects. The
// denominators are recomputed from the rows rather than stored. Any M >=
// 1; the last block masks its tail. No step crosses blocks.
//
// Bound (chip_smoke.py:tree_bound computes it for every timed call): per
// pair the rows in and out, 2 x 256 + 8 + 256 + 8 = 784 B of int64 limbs,
// and 6 Fp products (3 of batch inversion, lambda, lambda^2, lambda (xL -
// x3)) plus one per doubling, 264 32-bit multiply-adds each. At the
// prover's widths that is bound by bytes. Chain floor of a launch: one
// inversion plus 2 log2 nt product levels (chip_smoke.py:tree_floor).
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/msm/tree_kernels.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace zk {

constexpr int kTreeMaxBlock = 128;  // threads per block, at most
constexpr int kTreeMaxPairs = 8;    // pairs per thread, at most

struct PairIn {
  Fp xL, yL, xR, yR;
  bool infL, infR;
};

__device__ __forceinline__ PairIn load_pair(const int64_t* L, const int64_t* R,
                                            const int64_t* fl, size_t i) {
  PairIn p;
  p.xL = fp_load2(L + i * 32);
  p.yL = fp_load2(L + i * 32 + 16);
  p.xR = fp_load2(R + i * 32);
  p.yR = fp_load2(R + i * 32 + 16);
  uint32_t f = (uint32_t)fl[i];
  p.infL = (f & 1u) != 0;
  p.infR = (f & 2u) != 0;
  return p;
}

// The denominator (after the bad -> one substitution), the numerator and
// the pair's own infinity test, in tree_level_xla's order.
template <bool COMPLETE, bool WITH_NUM>
__device__ __forceinline__ void pair_terms(const PairIn& p, Fp& den, Fp& num,
                                           bool& inf_pair) {
  Fp d = fp_sub(p.xR, p.xL);
  bool xeq = fp_is_zero(d);
  Fp yd = fp_sub(p.yR, p.yL);
  bool yeq = fp_is_zero(yd);
  bool dbl = COMPLETE && xeq && yeq;
  den = dbl ? fp_dbl(p.yL) : d;
  if (WITH_NUM) {
    num = yd;
    if (dbl) {
      Fp x2 = fp_mul(p.xL, p.xL);
      num = fp_add(fp_dbl(x2), x2);
    }
  }
  inf_pair = COMPLETE ? (xeq && !yeq) : xeq;
  if (fp_is_zero(den) || p.infL || p.infR) den = fp_one();
}

// L, R, out (M, 32) rows: x limbs then y limbs; fl, ofl (M,). blockDim.x =
// nt, a power of two <= kTreeMaxBlock; per pairs a thread; dynamic shared
// memory (per - 1) * 8 * nt words.
template <bool COMPLETE>
__global__ void __launch_bounds__(kTreeMaxBlock, 4)
k_tree_level(const int64_t* __restrict__ L, const int64_t* __restrict__ R,
             const int64_t* __restrict__ fl, int64_t* __restrict__ out,
             int64_t* __restrict__ ofl, int M, int per) {
  // P_j, word-major: word k of thread t's P_j at (j * 8 + k) * nt + t
  ZK_DYNAMIC_SHARED(uint32_t, pre, (kTreeMaxPairs - 1) * 8 * kTreeMaxBlock);
  __shared__ Fp node[2 * kTreeMaxBlock];  // product tree, root at 1
  const int nt = blockDim.x, t = threadIdx.x;
  const long long first = (long long)blockIdx.x * nt * per + t;
  int nj = 0;  // this thread's pairs: j = 0 .. nj-1
  if (first < M) {
    long long n = (M - 1 - first) / nt + 1;
    nj = n < per ? (int)n : per;
  }

  // ---- forward: denominators and their running products
  Fp P = fp_one();
  for (int j = 0; j < nj; ++j) {
    PairIn p = load_pair(L, R, fl, (size_t)(first + (long long)j * nt));
    Fp den, num;
    bool inf_pair;
    pair_terms<COMPLETE, false>(p, den, num, inf_pair);
    if (j) {
#pragma unroll
      for (int k = 0; k < 8; ++k) pre[((j - 1) * 8 + k) * nt + t] = P.v[k];
      P = fp_mul(P, den);
    } else {
      P = den;
    }
  }

  // ---- mid: product tree over the chain totals, one inversion, down-sweep
  node[nt + t] = P;
  __syncthreads();
  for (int h = nt / 2; h >= 1; h >>= 1) {
    if (t < h) node[h + t] = fp_mul(node[2 * (h + t)], node[2 * (h + t) + 1]);
    __syncthreads();
  }
  if (t == 0) node[1] = fp_inv(node[1]);
  __syncthreads();
  for (int h = 1; h < nt; h <<= 1) {
    // children 2h .. 4h-1: 1/child = 1/parent * sibling, one a thread
    const int c = 2 * h + t;
    Fp v;
    if (t < 2 * h) v = fp_mul(node[c >> 1], node[c ^ 1]);
    __syncthreads();
    if (t < 2 * h) node[c] = v;
    __syncthreads();
  }
  Fp S = node[nt + t];  // 1 / P_{nj-1}

  // ---- backward: per-pair inverses, lambda, x3, y3, selects
  for (int j = nj - 1; j >= 0; --j) {
    size_t i = (size_t)(first + (long long)j * nt);
    PairIn p = load_pair(L, R, fl, i);
    Fp den, num;
    bool inf_pair;
    pair_terms<COMPLETE, true>(p, den, num, inf_pair);
    Fp dinv = S;
    if (j) {
      Fp Pm1;
#pragma unroll
      for (int k = 0; k < 8; ++k) Pm1.v[k] = pre[((j - 1) * 8 + k) * nt + t];
      dinv = fp_mul(S, Pm1);
      S = fp_mul(S, den);
    }
    Fp lam = fp_mul(num, dinv);
    Fp x3 = fp_sub(fp_sub(fp_mul(lam, lam), p.xL), p.xR);
    Fp y3 = fp_sub(fp_mul(lam, fp_sub(p.xL, x3)), p.yL);
    if (p.infR) {
      x3 = p.xL;
      y3 = p.yL;
    }
    if (p.infL) {
      x3 = p.xR;
      y3 = p.yR;
    }
    fp_store2(out + i * 32, x3);
    fp_store2(out + i * 32 + 16, y3);
    bool fin = !p.infL && !p.infR;
    ofl[i] = ((p.infL && p.infR) || (fin && inf_pair)) ? 1 : 0;
  }
}

}  // namespace zk

extern "C" {

// nt threads a block (a power of two, 32 .. 128), per pairs a thread (1 ..
// 8), as msm/tree_kernels.py:launch_shape gives them.
int tree_level(const int64_t* L, const int64_t* R, const int64_t* fl,
               int64_t* out, int64_t* ofl, int M, int complete, int nt,
               int per, void* stream) {
  if (nt < 32 || nt > zk::kTreeMaxBlock || (nt & (nt - 1)) || per < 1 ||
      per > zk::kTreeMaxPairs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long span = (long long)nt * per;
  dim3 g((unsigned)((M + span - 1) / span));
  size_t smem = (size_t)(per - 1) * 8 * nt * sizeof(uint32_t);
  if (complete)
    zk::k_tree_level<true><<<g, nt, smem, s>>>(L, R, fl, out, ofl, M, per);
  else
    zk::k_tree_level<false><<<g, nt, smem, s>>>(L, R, fl, out, ofl, M, per);
  return (int)cudaGetLastError();
}

}  // extern "C"
