"""K9's all-slot stage against the JAX package, and K9 itself built with
g++ on the host against its twin.

``ntt_rdma.exchange_butterfly`` on a CPU ``Mesh.virtual`` runs the stage's
twin over every slot, under both exchanges (``"rdma"``: each slot reads
its partner's shard; ``"ppermute"``: a copy of it). Each slot is held to
JAX per slot: the forward form to ``ntt_rdma._butterfly`` on the partner's
shard, the inverse form to JAX's two steps (``rlweq.mont_mul`` pre-scales
the v side, then ``_butterfly`` with tw = R mod q). Every hd of D = 2, 4,
8; a pair's two slots share their twiddle slice, as in the transform; 0, 1
and q - 1 planted in y, in the partner's shard (all nine pairs) and in tw.

The host build: ``-DZK_HOST_TEST`` turns ``csrc/ntt_rdma.cu``'s CUDA
keywords into C++ and a harness that defines ``ZK_HOST_THREADS`` runs the
kernel's blocks and threads one after another on a stage of four slots,
with partner pointers (rdma) and with separate copies (ppermute), forward
and inverse, 16-byte moves where S % 4 == 0 and single words at an odd S.
The source is cut before its C launchers. It skips without g++. Exact
integers: the tolerance is zero.
"""

import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.fields import rlweq as j_rlweq
from tpu_zkpool.parallel import ntt_rdma as j_rdma

from tpu_zkpool_torch.fields import rlweq as tq
from tpu_zkpool_torch.parallel import Mesh, ntt_rdma

Q = tq.Q
EDGE = np.array([0, 1, Q - 1], dtype=np.uint32)
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_zkpool_torch", "csrc")


def _q(shape, rng):
    return rng.integers(0, Q, shape, dtype=np.uint32)


def stage_inputs(D, B, S, hd, seed):
    """(ys (D, B >= 5, S), tws (D, S) alike over a pair, u (D,), partners):
    the last three rows all 0, 1, q - 1 (u slots) and q - 1, 0, 1 (v
    slots), the nine edge pairs in the first nine words (a u slot's pattern
    against a v slot's), the edge values in tw's first words."""
    rng = np.random.default_rng(seed)
    ys = _q((D, B, S), rng)
    u = np.array([(d // hd) % 2 == 0 for d in range(D)])
    for d in range(D):
        ys[d].reshape(-1)[:9] = (np.repeat(EDGE, 3) if u[d]
                                 else np.tile(EDGE, 3))
        ys[d, -3:] = (EDGE if u[d] else np.roll(EDGE, 1))[:, None]
    base = _q((hd, S), rng)
    base[:, :9] = np.tile(EDGE, 3)[:S]
    tws = np.stack([base[d % hd] for d in range(D)])
    return ys, tws, u, [d ^ hd for d in range(D)]


def jax_stage(ys, tws, u, partners, inverse):
    """JAX per slot, all slots at once: ``_butterfly`` on the partner's
    shard, after JAX's v-side pre-scale for the inverse."""
    Y, TW = jnp.asarray(ys), jnp.asarray(tws)[:, None, :]
    U = jnp.asarray(u)[:, None, None]
    if inverse:
        Y = jnp.where(U, Y, j_rlweq.mont_mul(Y, TW))
        TW = jnp.full_like(TW, np.uint32(j_rlweq.R_MOD_Q))
    return np.asarray(j_rdma._butterfly(Y, Y[np.asarray(partners)], TW, U))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_stage_twin_matches_jax(D, inverse):
    B, S = 5, 16
    mesh = Mesh.virtual((D,), ("sp",), device="cpu")
    hd = 1
    while hd < D:
        ys, tws, u, partners = stage_inputs(D, B, S, hd, seed=D * 10 + hd)
        want = jax_stage(ys, tws, u, partners, inverse)
        tys = [tq.from_numpy_u32(y, device="cpu") for y in ys]
        ttws = [tq.from_numpy_u32(t, device="cpu") for t in tws]
        for exchange in ("rdma", "ppermute"):
            outs = ntt_rdma.exchange_butterfly(mesh, tys, ttws, list(u),
                                               partners, exchange, inverse)
            for d in range(D):
                assert (tq.to_numpy_u32(outs[d]) == want[d]).all(), (
                    hd, exchange, d)
        hd *= 2


# ------------------------------------------------- the host build of K9

_HARNESS = r"""
#define ZK_HOST_TEST
#define ZK_HOST_THREADS
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
struct ZkDim3 {
  unsigned x, y, z;
};
inline ZkDim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{256, 1, 1};
#include "ntt_rdma_kernels.cu"
using namespace zk;

static std::vector<int64_t> rd(size_t n) {
  std::vector<int64_t> v(n);
  if (n && fread(v.data(), 8, n, stdin) != n) std::exit(3);
  return v;
}

static std::vector<int32_t> words(size_t n) {
  auto v = rd(n);
  return std::vector<int32_t>(v.begin(), v.end());
}

int main() {
  // slots, rows, S, inverse, vec, u_mask, then per slot its partner
  // (-1: its own other follows the ys); ys, the others, tws as int64
  auto h = rd(6);
  const int slots = (int)h[0];
  const int64_t n = h[1] * h[2];
  auto part = rd(slots);
  std::vector<std::vector<int32_t>> y(slots), o(slots), tw(slots), out(slots);
  for (int s = 0; s < slots; ++s) y[s] = words(n);
  for (int s = 0; s < slots; ++s)
    if (part[s] < 0) o[s] = words(n);
  for (int s = 0; s < slots; ++s) tw[s] = words(h[2]);
  StageArgs a{};
  a.rows = h[1];
  a.S = (int32_t)h[2];
  a.slots = slots;
  a.inverse = (int32_t)h[3];
  a.vec = (int32_t)h[4];
  a.u_mask = (uint32_t)h[5];
  for (int s = 0; s < slots; ++s) {
    out[s].assign(n, -7);
    a.y[s] = y[s].data();
    a.other[s] = part[s] < 0 ? o[s].data() : y[part[s]].data();
    a.tw[s] = tw[s].data();
    a.out[s] = out[s].data();
  }
  for (int64_t b = 0; b < stage_blocks(a); ++b)
    for (unsigned t = 0; t < (unsigned)kStageThreads; ++t) {
      blockIdx.x = (unsigned)b;
      threadIdx.x = t;
      k_exchange_butterfly(a);
    }
  for (int s = 0; s < slots; ++s) {
    std::vector<int64_t> w(out[s].begin(), out[s].end());
    fwrite(w.data(), 8, w.size(), stdout);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_k9(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: ntt_rdma.cu's host build cannot be made")
    d = tmp_path_factory.mktemp("ntt_rdma_host")
    with open(os.path.join(CSRC, "ntt_rdma.cu")) as f:
        cu = f.read()
    end = "}  // namespace zk"
    (d / "ntt_rdma_kernels.cu").write_text(cu[:cu.rindex(end) + len(end)]
                                           + "\n")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", f"-I{d}", str(d / "harness.cpp"),
                    "-o", str(exe)], check=True, capture_output=True,
                   text=True)
    return str(exe)


def _run(exe, ys, others, tws, u, inverse, vec):
    """The host kernel on a stage: ``others[s]`` a slot index (its partner's
    y) or an array of its own."""
    slots, (B, S) = len(ys), ys[0].shape
    head = [slots, B, S, int(inverse), int(vec),
            sum(int(x) << s for s, x in enumerate(u))]
    part = [o if isinstance(o, int) else -1 for o in others]
    parts = [np.array(head + part)] + list(ys) + [
        o for o in others if not isinstance(o, int)] + list(tws)
    res = subprocess.run([exe], check=True, capture_output=True, input=b"".join(
        np.ascontiguousarray(p, dtype=np.int64).tobytes() for p in parts))
    return np.frombuffer(res.stdout, np.int64).reshape(slots, B, S)


@pytest.mark.parametrize("S", [12, 7])
def test_host_k9_matches_twin(host_k9, S):
    """Four slots, pairs (0, 1) and (2, 3), 90 rows: two blocks a slot at S
    = 12 (int4 moves), three at S = 7 (words); rdma (partner pointers) and
    ppermute (copies), forward and inverse, against ``stage_plain``."""
    D, B, hd = 4, 90, 1
    ys, tws, u, partners = stage_inputs(D, B, S, hd, seed=S)
    t = lambda a: torch.as_tensor(a.astype(np.int32))
    for inverse in (False, True):
        want = ntt_rdma.stage_plain([t(y) for y in ys],
                                    [t(ys[p]) for p in partners],
                                    [t(w) for w in tws], list(u), inverse)
        for others in (partners, [ys[p].copy() for p in partners]):
            got = _run(host_k9, ys, others, tws, u, inverse, S % 4 == 0)
            for d in range(D):
                assert (got[d] == want[d].numpy()).all(), (inverse, d)
