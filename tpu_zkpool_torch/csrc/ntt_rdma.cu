// Kernel K9: one cross-shard butterfly stage of the coefficient-sharded
// negacyclic NTT over q = 167772161, for Hopper (sm_90a).
//
// Replaces the Pallas kernel tpu_zkpool/parallel/ntt_rdma.py _kernel /
// exchange_butterfly_rdma (pallas_call l.161). It computes what the TPU
// kernel's combine step computes (ntt_rdma._butterfly):
//
//   out = u_side ? y + other : (other - y) * tw        (mod q)
//
// with values in [0, q) held in int32 words and the product a Montgomery
// product with R = 2^28, the R every twiddle table of the JAX package
// carries (a 32-bit-word Montgomery, R = 2^32, would give other values).
// The forward stages pass the stage's twiddle slice; the inverse stages
// pre-scale the v side and pass tw = R mod q, making the product the
// identity.
//
// Design. The TPU kernel also moved the partner's rows: remote DMAs into
// two VMEM receive slots, chunk i+1's transfer in flight during chunk i's
// combine, a flow semaphore so a sender never overwrites a slot still being
// read. On a GPU the copy engines move the data and CUDA events order it:
// the wrapper (tpu_zkpool_torch/parallel/ntt_rdma.py:exchange_butterfly)
// copies each chunk into one of two receive slots on the receiving shard's
// copy stream and launches this kernel once per chunk on its compute
// stream, behind the copy's event; the copy into a slot waits on the event
// of the launch that last read it. This kernel is the combine alone: one
// thread per element, a block per row and 128 columns, any rows >= 1 and
// any S >= 1 (the last column block masks).
//
// Bound: bytes. Each element reads y and the receive slot and writes out
// (12 B), plus tw once; the v side's product is 5 32-bit multiply-adds (the
// 64-bit product, the quotient word, m * q), far below the memory time at
// any shape. At a chunk of 512 x 128 words the bytes take ~0.24 us, so a
// launch is held by its latency; fusing stages or loading the partner's
// rows in the kernel over peer access are later work.
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/parallel/ntt_rdma.py); returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace zk {

constexpr uint32_t kQ = 167772161u;
constexpr uint32_t kRMask = (1u << 28) - 1;
constexpr uint32_t kQInvNegR = 167772159u;  // -q^-1 mod 2^28
constexpr int kBfBlock = 128;

__device__ __forceinline__ uint32_t q_add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;
  return s >= kQ ? s - kQ : s;
}

__device__ __forceinline__ uint32_t q_sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + kQ - b;
}

// a * b * 2^-28 mod q for a, b < q: t + m q = 0 mod 2^28 and
// (t + m q) / 2^28 < 2q, one conditional subtraction.
__device__ __forceinline__ uint32_t q_mont_mul(uint32_t a, uint32_t b) {
  uint64_t t = (uint64_t)a * b;
  uint32_t m = ((uint32_t)t * kQInvNegR) & kRMask;
  uint32_t u = (uint32_t)((t + (uint64_t)m * kQ) >> 28);
  return u >= kQ ? u - kQ : u;
}

// y, other, out (rows, S); tw (S). Grid (rows, ceil(S / kBfBlock)).
__global__ void k_exchange_butterfly(const int32_t* __restrict__ y,
                                     const int32_t* __restrict__ other,
                                     const int32_t* __restrict__ tw,
                                     int32_t* __restrict__ out, int S,
                                     int u_side) {
  int j = blockIdx.y * kBfBlock + threadIdx.x;
  if (j >= S) return;
  size_t i = (size_t)blockIdx.x * S + j;
  uint32_t a = (uint32_t)y[i], b = (uint32_t)other[i];
  uint32_t r = u_side ? q_add(a, b) : q_mont_mul(q_sub(b, a), (uint32_t)tw[j]);
  out[i] = (int32_t)r;
}

}  // namespace zk

extern "C" {

int ntt_exchange_butterfly(const int32_t* y, const int32_t* other,
                           const int32_t* tw, int32_t* out, int rows, int S,
                           int u_side, void* stream) {
  if (rows < 1 || S < 1) return (int)cudaErrorInvalidValue;
  dim3 g(rows, (S + zk::kBfBlock - 1) / zk::kBfBlock);
  zk::k_exchange_butterfly<<<g, zk::kBfBlock, 0, (cudaStream_t)stream>>>(
      y, other, tw, out, S, u_side);
  return (int)cudaGetLastError();
}

}  // extern "C"
