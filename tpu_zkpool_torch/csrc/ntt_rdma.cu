// Kernel K9: one cross-shard butterfly stage of the coefficient-sharded
// negacyclic NTT over q = 167772161, for Hopper (sm_90a), over every slot
// of the mesh that lives on one device in one launch.
//
// Replaces the Pallas kernel tpu_zkpool/parallel/ntt_rdma.py _kernel /
// exchange_butterfly_rdma (pallas_call l.161). Per slot, with o the shard
// it combines with (its partner's y, or a copy of it) and tw its stage
// twiddle slice, values in [0, q) held in int32 words:
//
//   forward:  u side  y + o                v side  (o - y) * tw
//   inverse:  u side  y + o * tw           v side  o - y * tw      (mod q)
//
// The product is a Montgomery product with R = 2^28, the R every twiddle
// table of the JAX package carries. The TPU kernel computes only the
// forward form: JAX pre-scales the v side of an inverse stage by tw and
// calls it with tw = R mod q (ntt_sharded.py _inverse_traced). Here the
// inverse form takes the partner's unscaled shard and does that product
// itself; mont(., R mod q) is the identity on canonical values, so both
// give the same words. The two slots of a pair pass the same slice.
//
// Design. The TPU kernel moved the partner's rows itself, chunk by chunk
// into two VMEM receive slots, chunk i+1's DMA in flight during chunk i's
// combine, semaphores for flow control. On one card every shard already
// sits in device memory, so the kernel reads the partner's rows as it
// reads its own: the loads are the transfer, and the warps in flight
// overlap them; there is no receive buffer to double and no chunk
// schedule. One launch covers every slot on the device: a by-value
// parameter struct (StageArgs, ~1 KB of the 4 KB parameter space) holds
// each slot's pointers and side, so no table is uploaded. Blocks
// interleave the slots (block b serves slot b % slots), so a pair's two
// slots read the same rows close together in time and the second read
// tends to hit L2. Slots of a distinct card's partner read it over peer
// access (the wrapper enables it); that path needs two cards. A partner
// shard that another process owns is read through a CUDA IPC mapping of
// its block (ntt_ipc_* below), which the kernel sees as one more pointer:
// the counterpart of the TPU kernel's remote copy to another chip.
//
// Bound: bytes. Each element reads y and o and writes out (12 B; 8 B of
// device memory when o is the partner's own y and the second read hits
// L2), plus tw; one or two Montgomery products (5 32-bit multiply-adds
// each) are far below the memory time. A thread moves 16 B of each array
// (int4) where S % 4 == 0 and every pointer is 16-byte aligned, one word
// otherwise; the twiddle of flat element e is tw[e % S].
//
// Interface: plain C, launched on the caller's stream
// (tpu_zkpool_torch/parallel/ntt_rdma.py); returns cudaGetLastError().
//
// Host rehearsal: g++ -DZK_HOST_TEST builds everything above the end of
// namespace zk (tests/test_torch_k9_stage.py); a harness that defines
// ZK_HOST_THREADS brings its own threadIdx, blockIdx and blockDim.

#ifdef ZK_HOST_TEST
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct alignas(16) int4 {
  int x, y, z, w;
};
#ifndef ZK_HOST_THREADS
struct ZkDim3 {
  unsigned x, y, z;
};
inline ZkDim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
#endif
#else
#include <cuda_runtime.h>
#endif

#include <cstdint>
#include <cstring>

namespace zk {

constexpr uint32_t kQ = 167772161u;
constexpr uint32_t kRMask = (1u << 28) - 1;
constexpr uint32_t kQInvNegR = 167772159u;  // -q^-1 mod 2^28
constexpr int kMaxSlots = 32;
constexpr int kStageThreads = 256;

// One stage's arguments, passed by value. Bit s of u_mask: slot s is the
// u side. vec: move int4 (the wrapper sets it only where S % 4 == 0 and
// every pointer is 16-byte aligned).
struct StageArgs {
  const int32_t* y[kMaxSlots];
  const int32_t* other[kMaxSlots];
  const int32_t* tw[kMaxSlots];
  int32_t* out[kMaxSlots];
  int64_t rows;
  uint32_t u_mask;
  int32_t S;
  int32_t slots;
  int32_t inverse;
  int32_t vec;
};

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

__device__ __forceinline__ int32_t combine(int32_t y, int32_t o, int32_t w,
                                           bool u, bool inverse) {
  const uint32_t a = (uint32_t)y, b = (uint32_t)o, t = (uint32_t)w;
  uint32_t r;
  if (inverse)
    r = u ? q_add(a, q_mont_mul(b, t)) : q_sub(b, q_mont_mul(a, t));
  else
    r = u ? q_add(a, b) : q_mont_mul(q_sub(b, a), t);
  return (int32_t)r;
}

// Elements a thread covers, and blocks a slot and a launch take.
inline int64_t stage_per_thread(const StageArgs& a) { return a.vec ? 4 : 1; }

inline int64_t stage_blocks(const StageArgs& a) {
  const int64_t per_block = kStageThreads * stage_per_thread(a);
  return (a.rows * a.S + per_block - 1) / per_block * a.slots;
}

// Grid: stage_blocks(args) blocks of kStageThreads; block b serves slot
// b % slots, elements [b / slots * per_block, ...) of its flat shard.
__global__ void __launch_bounds__(kStageThreads)
    k_exchange_butterfly(const StageArgs args) {
  const int slot = (int)(blockIdx.x % (unsigned)args.slots);
  const int64_t chunk = blockIdx.x / (unsigned)args.slots;
  const bool u = (args.u_mask >> slot) & 1u, inv = args.inverse != 0;
  const int64_t n = args.rows * args.S;
  const int32_t* y = args.y[slot];
  const int32_t* o = args.other[slot];
  const int32_t* tw = args.tw[slot];
  int32_t* out = args.out[slot];
  if (args.vec) {
    const int64_t e = (chunk * kStageThreads + threadIdx.x) * 4;
    if (e >= n) return;
    const int4 a = *reinterpret_cast<const int4*>(y + e);
    const int4 b = *reinterpret_cast<const int4*>(o + e);
    const int4 w = *reinterpret_cast<const int4*>(tw + e % args.S);
    int4 r;
    r.x = combine(a.x, b.x, w.x, u, inv);
    r.y = combine(a.y, b.y, w.y, u, inv);
    r.z = combine(a.z, b.z, w.z, u, inv);
    r.w = combine(a.w, b.w, w.w, u, inv);
    *reinterpret_cast<int4*>(out + e) = r;
  } else {
    const int64_t e = chunk * kStageThreads + threadIdx.x;
    if (e >= n) return;
    out[e] = combine(y[e], o[e], tw[e % args.S], u, inv);
  }
}

}  // namespace zk

extern "C" {

int ntt_stage_args_size() { return (int)sizeof(zk::StageArgs); }

int ntt_max_slots() { return zk::kMaxSlots; }

int ntt_exchange_butterfly(const zk::StageArgs* args, void* stream) {
  if (args->rows < 1 || args->S < 1 || args->slots < 1 ||
      args->slots > zk::kMaxSlots)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = zk::stage_blocks(*args);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  zk::k_exchange_butterfly<<<(unsigned)blocks, zk::kStageThreads, 0,
                             (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// Let the current device read `peer`'s memory; "already enabled" counts
// as success.
int ntt_enable_peer(int peer) {
  cudaError_t e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return 0;
  }
  return (int)e;
}

// CUDA IPC, so that K9 reads a partner shard that another process owns.
// A caching allocator's tensor is a suballocation: the handle covers the
// whole allocation (its block), so the export also returns the tensor's
// byte offset in it, found by the driver's cuMemGetAddressRange (reached
// through the runtime, so the library links no libcuda). A failed call's
// error is cleared, so the next launch's cudaGetLastError does not report
// it; the wrapper raises with its name.

int ntt_ipc_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

typedef int (*AddressRangeFn)(unsigned long long*, size_t*,
                              unsigned long long);

static cudaError_t address_range(AddressRangeFn* fn) {
  static AddressRangeFn found = nullptr;
  if (!found) {
    void* p = nullptr;
#if CUDART_VERSION >= 12000
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuMemGetAddressRange", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuMemGetAddressRange", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !p) return cudaErrorNotSupported;
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuMemGetAddressRange_v2", &p,
                                            cudaEnableDefault);
    if (e != cudaSuccess) return e;
    if (!p) return cudaErrorNotSupported;
#endif
    found = (AddressRangeFn)p;
  }
  *fn = found;
  return cudaSuccess;
}

static int failed(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// The handle of the allocation that holds `ptr` (64 bytes into `handle`)
// and ptr's byte offset from the allocation's base.
int ntt_ipc_export(const void* ptr, void* handle, unsigned long long* offset) {
  AddressRangeFn range;
  cudaError_t e = address_range(&range);
  if (e != cudaSuccess) return failed(e);
  unsigned long long base = 0;
  size_t size = 0;
  if (range(&base, &size, (unsigned long long)(uintptr_t)ptr) != 0)
    return failed(cudaErrorInvalidDevicePointer);
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, (void*)(uintptr_t)base);
  if (e != cudaSuccess) return failed(e);
  memcpy(handle, &h, sizeof h);
  *offset = (unsigned long long)(uintptr_t)ptr - base;
  return 0;
}

// Map another process's allocation into the current device's context
// (over peer access where it lies on another card).
int ntt_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  cudaError_t e = cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  return e == cudaSuccess ? 0 : failed(e);
}

int ntt_ipc_close(void* ptr) {
  cudaError_t e = cudaIpcCloseMemHandle(ptr);
  return e == cudaSuccess ? 0 : failed(e);
}

// CUDA's name and description of an error code the entry points return.
const char* ntt_error_name(int code) {
  return cudaGetErrorName((cudaError_t)code);
}

const char* ntt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
