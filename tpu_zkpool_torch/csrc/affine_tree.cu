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
// Design. One block of 128 threads owns 1,024 consecutive pairs, each thread
// the 8 pairs t, t + 128, ... of them (neighbouring threads read
// neighbouring rows). Forward: each thread forms its denominators and their
// running products P_j, kept in shared memory. Mid: a product tree over the
// threads' chain totals in shared memory, one Fermat inversion of the block
// total by thread 0 (exponent p - 2: 253 squarings and 109 products), and a
// down-sweep that hands each thread the inverse S of its chain total.
// Backward: each thread walks its pairs from last to first, dinv = S P_{j-1}
// and S <- S den_j, then lambda, x3, y3 and the selects. The denominators
// are recomputed from the rows rather than stored. Any M >= 1; the last
// block masks its tail. No step crosses blocks.
//
// Bound (chip_smoke.py:tree_bound computes it for every timed call): per
// pair the rows in and out, 2 x 256 + 8 + 256 + 8 = 784 B of int64 limbs,
// and 6 Fp products (3 of batch inversion, lambda, lambda^2, lambda (xL -
// x3)) plus one per doubling, 264 32-bit multiply-adds each. At the
// prover's widths that is bound by bytes. This design pays one serial
// Fermat chain (362 dependent products in one thread) per block, a latency
// floor under every launch whatever M is; one inversion per launch, a
// faster inverse or a chain spread over a warp's lanes are later work.
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/msm/tree_kernels.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace zk {

constexpr int kTreeBlock = 128;  // threads per block
constexpr int kTreePairs = 8;    // pairs per thread

// a^(p-2), Montgomery in and out: square-and-multiply from the top bit of
// p - 2 (bit 253) down. p's low word is odd and above 2, so only word 0
// of p - 2 differs from p's.
__device__ Fp fp_inv(const Fp& a) {
  Fp acc = a;
  for (int i = 252; i >= 0; --i) {
    acc = fp_mul(acc, acc);
    uint32_t w = kP[i >> 5] - (i < 32 ? 2u : 0u);
    if ((w >> (i & 31)) & 1u) acc = fp_mul(acc, a);
  }
  return acc;
}

struct PairIn {
  Fp xL, yL, xR, yR;
  bool infL, infR;
};

__device__ __forceinline__ PairIn load_pair(const int64_t* L, const int64_t* R,
                                            const int64_t* fl, size_t i) {
  PairIn p;
  p.xL = fp_load(L + i * 32);
  p.yL = fp_load(L + i * 32 + 16);
  p.xR = fp_load(R + i * 32);
  p.yR = fp_load(R + i * 32 + 16);
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

// L, R, out (M, 32) rows: x limbs then y limbs; fl, ofl (M,).
template <bool COMPLETE>
__global__ void __launch_bounds__(kTreeBlock)
k_tree_level(const int64_t* __restrict__ L, const int64_t* __restrict__ R,
             const int64_t* __restrict__ fl, int64_t* __restrict__ out,
             int64_t* __restrict__ ofl, int M) {
  __shared__ uint32_t pre[kTreePairs][8][kTreeBlock];  // P_j, word-major
  __shared__ Fp node[2 * kTreeBlock];                  // product tree
  const int t = threadIdx.x;
  const long long first =
      (long long)blockIdx.x * kTreeBlock * kTreePairs + t;
  int nj = 0;  // this thread's pairs: j = 0 .. nj-1
  if (first < M) {
    long long n = (M - 1 - first) / kTreeBlock + 1;
    nj = n < kTreePairs ? (int)n : kTreePairs;
  }

  // ---- forward: denominators and their running products
  Fp P = fp_one();
  for (int j = 0; j < nj; ++j) {
    PairIn p = load_pair(L, R, fl, (size_t)(first + (long long)j * kTreeBlock));
    Fp den, num;
    bool inf_pair;
    pair_terms<COMPLETE, false>(p, den, num, inf_pair);
    P = j ? fp_mul(P, den) : den;
#pragma unroll
    for (int k = 0; k < 8; ++k) pre[j][k][t] = P.v[k];
  }

  // ---- mid: product tree over the chain totals, one inversion, down-sweep
  node[kTreeBlock + t] = P;
  __syncthreads();
  for (int h = kTreeBlock / 2; h >= 1; h >>= 1) {
    if (t < h) node[h + t] = fp_mul(node[2 * (h + t)], node[2 * (h + t) + 1]);
    __syncthreads();
  }
  if (t == 0) node[1] = fp_inv(node[1]);
  __syncthreads();
  for (int h = 1; h < kTreeBlock; h <<= 1) {
    if (t < h) {
      int i = h + t;
      Fp v = node[i], a = node[2 * i], b = node[2 * i + 1];
      node[2 * i] = fp_mul(v, b);  // 1/a = 1/(ab) * b
      node[2 * i + 1] = fp_mul(v, a);
    }
    __syncthreads();
  }
  Fp S = node[kTreeBlock + t];  // 1 / P_{nj-1}

  // ---- backward: per-pair inverses, lambda, x3, y3, selects
  for (int j = nj - 1; j >= 0; --j) {
    size_t i = (size_t)(first + (long long)j * kTreeBlock);
    PairIn p = load_pair(L, R, fl, i);
    Fp den, num;
    bool inf_pair;
    pair_terms<COMPLETE, true>(p, den, num, inf_pair);
    Fp dinv = S;
    if (j) {
      Fp Pm1;
#pragma unroll
      for (int k = 0; k < 8; ++k) Pm1.v[k] = pre[j - 1][k][t];
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
    fp_store(out + i * 32, x3);
    fp_store(out + i * 32 + 16, y3);
    bool fin = !p.infL && !p.infR;
    ofl[i] = ((p.infL && p.infR) || (fin && inf_pair)) ? 1 : 0;
  }
}

}  // namespace zk

extern "C" {

int tree_level(const int64_t* L, const int64_t* R, const int64_t* fl,
               int64_t* out, int64_t* ofl, int M, int complete, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int per = zk::kTreeBlock * zk::kTreePairs;
  dim3 g((M + per - 1) / per);
  if (complete)
    zk::k_tree_level<true><<<g, zk::kTreeBlock, 0, s>>>(L, R, fl, out, ofl, M);
  else
    zk::k_tree_level<false><<<g, zk::kTreeBlock, 0, s>>>(L, R, fl, out, ofl,
                                                         M);
  return (int)cudaGetLastError();
}

}  // extern "C"
