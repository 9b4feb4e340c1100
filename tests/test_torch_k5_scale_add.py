"""K5's twin, ``scale_add_plain``, against the JAX package's jitted
``XlaBackend(ncomp).scale_add`` (``addn(_dbl_n(a, s), b)``) limb for limb
(tolerance zero), and a pure-int oracle in affine form; then K4 and K5
themselves, built from ``csrc/msm_grid.cu`` with g++ on the host, against
their twins.

The redesigned K5 keeps the order (s doublings, then one complete add), so
twin, kernel and JAX agree on every limb. Planted rows, by row % 8: b = 2^s
a (the add doubles), b = -2^s a (it cancels), b the identity, a the
identity, both identities with nonzero X and Y, random. JAX is compiled
once for each case: over Fp at s = 0, 1 and 7 (~8 s each), over Fp2 at s
= 7 (~35-40 s: the Fp2 point add's XLA compile is the floor).

The host build: ``-DZK_HOST_TEST`` turns the CUDA keywords into C++ (the
shims of ``field.cuh``) and a harness defines ``ZK_HOST_THREADS``: it runs
K4's threads one after another over several blocks, and each row of K5 as
one block of 32 ``std::thread``s whose warp shuffles go through a slot
array between two waits on a ``std::barrier``. The source is cut before
its C launchers. It skips without g++.
"""

import functools
import os
import random
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from tpu_zkpool.msm import grid as jg

from test_torch_k4_addn import MODES, modes, planted
from test_torch_msm_grid import _add, _affine, _g_points, _jacobian, \
    _mul, _neg, _rand_z
from tpu_zkpool_torch.fields.bn254 import FP_MOD
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.msm import grid as tg

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_zkpool_torch", "csrc")
CASES = ((1, 0), (1, 1), (1, 7), (2, 7))       # (ncomp, s) held to JAX
ROWS = 16


@functools.lru_cache(maxsize=None)
def scale_rows(ncomp, s, n=ROWS):
    """(a, b, the affine points of a and b) planted as the module says."""
    rng = random.Random(20 + 3 * s + ncomp)
    pts = _g_points(ncomp, n, 30 + ncomp)
    a, b = list(pts), [pts[(i + 3) % n] for i in range(n)]
    for i in range(n):
        kind = i % 8
        if kind in (0, 1):
            q = _mul(ncomp, 1 << s, pts[i])
            b[i] = q if kind == 0 else _neg(ncomp, q)
        elif kind == 2:
            b[i] = None
        elif kind in (3, 4):
            a[i] = None
        if kind == 4:
            b[i] = None
    rows = []
    for p in (a, b):
        r = _jacobian(ncomp, p, [_rand_z(ncomp, rng) for _ in p])
        r[4::8, :2] = torch.as_tensor(FP.to_mont(
            [[[rng.randrange(1, FP_MOD) for _ in range(ncomp)]
              for _ in range(2)] for _ in range(len(r[4::8]))]))
        rows.append(r)
    return rows[0], rows[1], a, b


@functools.lru_cache(maxsize=None)
def _jax_scale_add(ncomp, s):
    be = jg.XlaBackend(ncomp)
    return jax.jit(lambda x, y: be.scale_add(x, y, s))


@pytest.mark.parametrize("ncomp,s", CASES)
def test_scale_add_plain_matches_jax_and_oracle(ncomp, s):
    a, b, pa, pb = scale_rows(ncomp, s)
    got = tg.scale_add_plain(a, b, s)
    u32 = lambda t: t.numpy().astype(np.uint32)
    want = _jax_scale_add(ncomp, s)(u32(a), u32(b))
    assert torch.equal(got, torch.as_tensor(np.asarray(want)
                                            .astype(np.int64)))
    for i in range(ROWS):
        p = None if pa[i] is None else _mul(ncomp, 1 << s, pa[i])
        assert _affine(ncomp, got[i]) == _add(ncomp, p, pb[i])
    assert _affine(ncomp, got[1]) is None              # cancelled
    assert got[0, 2].any()                             # doubled


# ------------------------------------------------- the host build of K4, K5

_HARNESS = r"""
#define ZK_HOST_TEST
#define ZK_HOST_THREADS
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
struct ZkDim3 {
  unsigned x, y, z;
};
inline thread_local ZkDim3 threadIdx{0, 0, 0};
inline ZkDim3 blockIdx{0, 0, 0}, blockDim{32, 1, 1};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// one warp: each lane writes its word, all wait, each reads lane src's,
// all wait again
inline std::barrier<>* zk_warp;
inline uint32_t zk_slot[32];
inline uint32_t zk_shfl(uint32_t v, int src) {
  zk_slot[threadIdx.x % 32] = v;
  zk_warp->arrive_and_wait();
  const uint32_t r = zk_slot[src & 31];
  zk_warp->arrive_and_wait();
  return r;
}
inline uint32_t __shfl_sync(unsigned, uint32_t v, int s, int = 32) {
  return zk_shfl(v, s);
}
inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int m, int = 32) {
  return zk_shfl(v, (threadIdx.x % 32) ^ m);
}
inline uint32_t __shfl_up_sync(unsigned, uint32_t v, int d, int = 32) {
  const int t = threadIdx.x % 32;
  return zk_shfl(v, t >= d ? t - d : t);
}
inline uint32_t __shfl_down_sync(unsigned, uint32_t v, int d, int = 32) {
  const int t = threadIdx.x % 32;
  return zk_shfl(v, t + d < 32 ? t + d : t);
}
inline void __syncthreads() { zk_warp->arrive_and_wait(); }
#include "msm_grid_kernels.cu"
using namespace zk;

static std::vector<int64_t> rd(size_t n) {
  std::vector<int64_t> v(n);
  if (n && fread(v.data(), 8, n, stdin) != n) std::exit(3);
  return v;
}

template <class S>
static void addn(int n, int64_t na, int64_t nb, int64_t fl, int neg_b) {
  using F = typename S::F;
  const size_t row = 3 * F::NC * 16;
  auto a = rd(na * row), b = rd(nb * row);
  auto ia = rd(fl & 1 ? n : 0), ib = rd(fl & 2 ? n : 0);
  auto zl = rd(fl & 4 ? n : 0);
  std::vector<uint8_t> z(zl.begin(), zl.end());
  std::vector<int64_t> out(n * row, -7);
  for (int i = 0; i < n; ++i) {
    blockIdx.x = i / S::kBlock;
    threadIdx.x = i % S::kBlock;
    k_addn<F, S::kBlock, S::kMin>(a.data(), b.data(),
                                  fl & 1 ? ia.data() : nullptr,
                                  fl & 2 ? ib.data() : nullptr,
                                  fl & 4 ? z.data() : nullptr, out.data(), n,
                                  na, nb, neg_b);
  }
  fwrite(out.data(), 8, out.size(), stdout);
}

template <class F>
static void scale_add(int n, int s) {
  const size_t row = 3 * F::NC * 16;
  auto a = rd(n * row), b = rd(n * row);
  std::vector<int64_t> out(n * row, -7);
  std::barrier<> bar(32);
  zk_warp = &bar;
  for (int r = 0; r < n; ++r) {
    blockIdx.x = r;
    std::vector<std::thread> th;
    for (int t = 0; t < 32; ++t)
      th.emplace_back([&, t] {
        threadIdx.x = t;
        k_scale_add<F>(a.data(), b.data(), out.data(), s);
      });
    for (auto& x : th) x.join();
  }
  fwrite(out.data(), 8, out.size(), stdout);
}

int main() {
  // op (0 K4, 1 K5), ncomp, n, rows of a, rows of b, flags (ia 1, ib 2,
  // zero 4), neg_b or s; then a, b, ia, ib, zero as int64
  auto h = rd(7);
  if (h[0] == 0 && h[1] == 1)
    addn<AddnShape<1>>(h[2], h[3], h[4], h[5], h[6]);
  else if (h[0] == 0)
    addn<AddnShape<2>>(h[2], h[3], h[4], h[5], h[6]);
  else if (h[1] == 1)
    scale_add<FpWarp>(h[2], h[6]);
  else
    scale_add<Fp2Warp>(h[2], h[6]);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: msm_grid.cu's host build cannot be made")
    d = tmp_path_factory.mktemp("msm_grid_host")
    with open(os.path.join(CSRC, "msm_grid.cu")) as f:
        cu = f.read()
    end = "}  // namespace zk"
    (d / "msm_grid_kernels.cu").write_text(
        cu[:cu.rindex(end) + len(end)].replace(
            "#include <cuda_runtime.h>\n", "") + "\n")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", f"-I{CSRC}",
                    f"-I{d}", str(d / "harness.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
    return str(exe)


def _run(exe, op, a, b, ia=None, ib=None, zero=None, arg=0):
    n = next((t.shape[0] for t in (ia, ib, zero) if t is not None),
             a.shape[0])
    flags = (ia is not None) | (ib is not None) << 1 | (zero is not None) << 2
    parts = [np.array([op, a.shape[2], n, a.shape[0], b.shape[0], flags,
                       int(arg)]), a.numpy(), b.numpy()] + [
        t.numpy() for t in (ia, ib, zero) if t is not None]
    out = subprocess.run([exe], check=True, capture_output=True, input=b"".join(
        np.ascontiguousarray(p, dtype=np.int64).tobytes() for p in parts))
    return torch.as_tensor(np.frombuffer(out.stdout, np.int64).copy()).reshape(
        (n,) + a.shape[1:])


@pytest.mark.parametrize("ncomp", [1, 2])
def test_host_k4_matches_twin(host_kernels, ncomp):
    """Every mode of ``test_torch_k4_addn`` on 300 rows (ten blocks)."""
    for mode, kw in modes(planted(ncomp, 300, 1)).items():
        got = _run(host_kernels, 0, kw["a"], kw["b"], kw.get("ia"),
                   kw.get("ib"), kw.get("zero"), kw.get("neg_b", False))
        assert torch.equal(got, tg.addn_plain(**kw)), mode
    assert len(MODES) == 8


@pytest.mark.parametrize("ncomp", [1, 2])
def test_host_k5_matches_twin(host_kernels, ncomp):
    """Four rows (blocks) a case: the doubling, the cancelling add, a the
    identity, both identities with nonzero X and Y."""
    rows = torch.tensor([0, 1, 3, 4])
    for s in (0, 1, 7):
        a, b = (t[rows] for t in scale_rows(ncomp, s)[:2])
        got = _run(host_kernels, 1, a, b, arg=s)
        assert torch.equal(got, tg.scale_add_plain(a, b, s)), s
