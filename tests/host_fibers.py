"""The host rehearsal of a CUDA block for the g++ builds of the port's
kernels (``-DZK_HOST_TEST``): ``SHIMS`` is C++ that runs a block's threads
as fibers on one host thread (``zk_run_block``), a barrier handing control
to the next thread, with the warp's shuffles and ballots on per-lane slots
(at most 128 lanes shuffle). A harness defines its kernel's thread function
after it and runs each block of the launch in turn.
"""

SHIMS = r"""
#define ZK_HOST_TEST
#define ZK_HOST_THREADS
#include <ucontext.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
struct ZkDim3 {
  unsigned x, y, z;
};
inline ZkDim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{32, 1, 1};
// A block's threads are fibers on one host thread, run in turn: a barrier
// passes control to the next thread, and the last one's to the first, so a
// thread resumes once every thread of the block has reached the barrier
// (the kernel's threads meet the same barriers in the same order). A
// shuffle writes the lane's value, waits, reads the source lane's and
// waits again; a ballot reads every lane's of its warp.
inline std::vector<ucontext_t> zk_fiber;
inline ucontext_t zk_main;
inline unsigned zk_done;
inline uint64_t zk_slot[128];
inline void zk_wait() {
  const unsigned t = threadIdx.x, next = (t + 1) % blockDim.x;
  threadIdx.x = next;
  swapcontext(&zk_fiber[t], &zk_fiber[next]);
}
template <class T>
inline T zk_shfl(T v, int src) {
  const unsigned warp = threadIdx.x & ~31u;
  zk_slot[threadIdx.x] = (uint64_t)v;
  zk_wait();
  const T r = (T)zk_slot[warp + (src & 31)];
  zk_wait();
  return r;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int s, int = 32) {
  return zk_shfl(v, s);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int m, int = 32) {
  return zk_shfl(v, (int)(threadIdx.x % 32) ^ m);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, int d, int = 32) {
  const int t = threadIdx.x % 32;
  return zk_shfl(v, t >= d ? t - d : t);
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, int d, int = 32) {
  const int t = threadIdx.x % 32;
  return zk_shfl(v, t + d < 32 ? t + d : t);
}
inline uint32_t __ballot_sync(unsigned, int pred) {
  const unsigned warp = threadIdx.x & ~31u;
  zk_slot[threadIdx.x] = pred ? 1 : 0;
  zk_wait();
  uint32_t m = 0;
  for (int i = 0; i < 32; ++i) m |= (uint32_t)zk_slot[warp + i] << i;
  zk_wait();
  return m;
}
inline void __syncthreads() { zk_wait(); }
// Run `fn` as the `block` threads of one block, one after another up to
// each barrier.
inline void (*zk_fn)();
inline void zk_thread() {
  zk_fn();
  const unsigned t = threadIdx.x;
  if (++zk_done == blockDim.x) setcontext(&zk_main);
  threadIdx.x = (t + 1) % blockDim.x;
  setcontext(&zk_fiber[threadIdx.x]);
}
inline void zk_run_block(unsigned block, void (*fn)()) {
  constexpr size_t kStack = 1 << 16;
  static std::vector<char> stacks;
  stacks.resize((size_t)block * kStack);
  zk_fiber.resize(block);
  blockDim.x = block;
  zk_fn = fn;
  zk_done = 0;
  for (unsigned t = 0; t < block; ++t) {
    getcontext(&zk_fiber[t]);
    zk_fiber[t].uc_stack.ss_sp = stacks.data() + (size_t)t * kStack;
    zk_fiber[t].uc_stack.ss_size = kStack;
    zk_fiber[t].uc_link = nullptr;
    makecontext(&zk_fiber[t], zk_thread, 0);
  }
  threadIdx.x = 0;
  swapcontext(&zk_main, &zk_fiber[0]);
}
static std::vector<int64_t> rd(size_t n) {
  std::vector<int64_t> v(n);
  if (n && fread(v.data(), 8, n, stdin) != n) std::abort();
  return v;
}
"""
