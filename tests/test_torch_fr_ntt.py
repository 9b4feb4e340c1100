"""The H(X) kernels P4 and P5 (``csrc/fr_ntt.cu``): their plain forms
against the JAX package, the kernel route's stage plan on the CPU, and
the kernels built with g++ against the plain forms.

- ``domain.forward_plain`` / ``inverse_plain`` and the stage plan the
  kernel route runs (``domain._stages``: P4's fused steps at a transform's
  ends, here over ``stage_plain``, P4's CPU form) equal
  ``tpu_zkpool.groth16.domain`` at n = 16 and 64 on seeded inputs (one
  jitted JAX call a size), and the prover's ``_h_pipeline`` on that plan
  equals JAX's at n = 16.
- A CPU tensor reaches the plain forms (a spy on them and on P4).
- The host build: ``-DZK_HOST_TEST`` turns ``csrc/fr_ntt.cu``'s CUDA
  keywords into C++ (``field.cuh``'s shims) and a harness that defines
  ``ZK_HOST_THREADS`` runs every block's threads of a launch one after
  another, the launch shaped as the C launcher shapes it. The source is
  cut before its C launchers. P4 at every h for n = 2 ... 64, both
  directions, P = 1 and 3, each fused step alone, all together and in
  place, with 0, 1 and r - 1 planted in the values and the twiddles,
  equals ``stage_plain``; P5 in each mode equals FieldCtx. It skips
  without g++. Exact integers: the tolerance is zero.

CPU parity proves the algorithm, not the CUDA build: ``chip_smoke.py``
phase 2 holds the kernels to the same plain forms on the card.
"""

import functools
import os
import random
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.groth16 import domain as jd
from tpu_zkpool.groth16 import prove_tpu as jpt

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.fields.limbs import ints_to_limbs
from tpu_zkpool_torch.groth16 import domain as td
from tpu_zkpool_torch.groth16 import ntt_kernels as nk
from tpu_zkpool_torch.groth16 import prove as tp

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_zkpool_torch", "csrc")
EDGE = (0, 1, R - 1)


def _vals(shape, seed, planted=0.25):
    """Seeded canonical limbs int64[*shape, 16]: random values below r,
    about ``planted`` of them 0, 1 or r - 1."""
    rng = random.Random(seed)
    flat = [rng.choice(EDGE) if rng.random() < planted else rng.randrange(R)
            for _ in range(int(np.prod(shape)))]
    return torch.as_tensor(ints_to_limbs(np.asarray(
        flat, dtype=object).reshape(shape)))


def _same(jax_out, port_out):
    assert (np.asarray(jax_out).astype(np.int64) == port_out.numpy()).all()


# ------------------------------------- plain forms and the plan against JAX

NTT_FNS = ("forward", "inverse", "interpolate_natural", "coset_forward",
           "coset_inverse")


@functools.lru_cache(maxsize=None)
def _jax_ntt(n):
    """Inputs (two polynomials) and the JAX outputs of every NTT function
    at size n, from one jitted call (one compile per n)."""
    x = _vals((2, n), 1000 + n)
    outs = jax.jit(lambda v: tuple(getattr(jd, f)(v) for f in NTT_FNS))(
        jnp.asarray(x.numpy().astype(np.uint32)))
    return x, dict(zip(NTT_FNS, outs))


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("fn", ["forward", "inverse"])
def test_plain_forms_match_jax(n, fn):
    x, want = _jax_ntt(n)
    _same(want[fn], getattr(td, fn + "_plain")(x))


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("fn", NTT_FNS)
def test_stage_plan_matches_jax(n, fn, monkeypatch):
    """The kernel route's plan (first stage out of place with the
    bit-reversed read or the coset powers, the rest in place, n^-1 and the
    coset inverse powers on the last) run through P4's CPU form."""
    x, want = _jax_ntt(n)
    monkeypatch.setattr(td, "_plain", lambda t: False)
    nk.reset_launches()
    _same(want[fn], getattr(td, fn)(x))


@pytest.mark.parametrize("demont", [False, True])
def test_h_pipeline_on_stage_plan_matches_jax(demont, monkeypatch):
    """The prover's H(X) on the kernel route's plan (P4's and P5's CPU
    forms) against JAX's jitted ``_h_pipeline`` at n = 16, and both
    pipelines of the port."""
    n = 16
    evs = _vals((3, n), 77)
    tinv = _vals((), 78, planted=0)
    tables = td.tables(n, "cpu")
    want = jpt._h_pipeline(jnp.asarray(evs.numpy().astype(np.uint32)),
                           jnp.asarray(tinv.numpy().astype(np.uint32)),
                           jd.tables_device(n), demont)
    plain = tp._h_pipeline(evs, tinv, tables, demont)
    monkeypatch.setattr(td, "_plain", lambda t: False)
    for pipeline in (tp._h_pipeline, tp._h_pipeline_split):
        got = pipeline(evs, tinv, tables, demont)
        _same(want, got)
        assert torch.equal(got, plain)


def test_cpu_tensors_reach_the_plain_forms(monkeypatch):
    """On a CPU tensor every public function runs the plain forms and P4's
    wrapper never runs; P5's wrapper runs ``pointwise_plain``."""
    calls = []

    def spy(name, f):
        def g(*a, **k):
            calls.append(name)
            return f(*a, **k)
        return g

    for name in ("forward_plain", "inverse_plain", "stage_plain",
                 "pointwise_plain"):
        monkeypatch.setattr(td, name, spy(name, getattr(td, name)))
    monkeypatch.setattr(nk, "stage", spy("stage", nk.stage))
    x = _vals((2, 8), 5)
    for fn in NTT_FNS:
        getattr(td, fn)(x)
    assert calls == ["forward_plain", "inverse_plain", "inverse_plain",
                     "forward_plain", "inverse_plain"]
    calls.clear()
    nk.pointwise(x, _vals((), 6))
    assert calls == ["pointwise_plain"]


def test_tables_power_rows_back_every_stage():
    """``pw`` / ``pw_inv`` rows are the stages' twiddles at stride n/2h:
    each stage is a view of them (no copy) equal to the host tables."""
    n = 32
    t = td.tables(n, "cpu")
    fwd, inv = td._tables(n)[:2]
    assert t["pw"].shape == t["pw_inv"].shape == (n // 2, 16)
    for tws, host, pw in ((t["fwd"], fwd, t["pw"]),
                          (t["inv"], inv, t["pw_inv"])):
        assert len(tws) == len(host) == 5
        for tw, h in zip(tws, host):
            assert tw.untyped_storage().data_ptr() == \
                pw.untyped_storage().data_ptr()
            assert (tw.T.numpy() == h).all()


# ----------------------------------------------- the host build of P4, P5

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
inline ZkDim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
// field.cuh's warp traits name a shuffle; P4 and P5 never shuffle
inline uint32_t __shfl_sync(unsigned, uint32_t v, int, int = 32) { return v; }
#include "fr_ntt_kernels.cu"
using namespace zk;

static std::vector<int64_t> take(size_t n) {
  std::vector<int64_t> v(n);
  if (n && fread(v.data(), 8, n, stdin) != n) std::exit(3);
  return v;
}

// Every block's threads of a launch of `threads` threads, in turn.
template <class F>
static void launch(long long threads, F kernel) {
  blockDim.x = kFrBlock;
  const long long blocks = (threads + kFrBlock - 1) / kFrBlock;
  for (long long b = 0; b < blocks; ++b)
    for (unsigned t = 0; t < (unsigned)kFrBlock; ++t) {
      blockIdx.x = (unsigned)b;
      threadIdx.x = t;
      kernel();
    }
}

int main() {
  int64_t kind;
  // stage:     0, P, log_n, log_h, dif, bitrev, pre, post, scalar, inplace,
  //            then y, pw, [pre], [post], [post_scalar]
  // pointwise: 1, N, quotient, then a, [b, c], t
  while (fread(&kind, 8, 1, stdin) == 1) {
    if (kind == 0) {
      auto h = take(9);
      const long long P = h[0];
      const int log_n = (int)h[1];
      const long long n = 1LL << log_n;
      auto y = take(P * n * 16);
      auto pw = take(n / 2 * 16);
      std::vector<int64_t> pre, post, sc;
      if (h[5]) pre = take(n * 16);
      if (h[6]) post = take(n * 16);
      if (h[7]) sc = take(16);
      std::vector<int64_t> out(P * n * 16, -7);
      if (h[8]) out = y;
      FrStageArgs a{h[8] ? out.data() : y.data(), out.data(), pw.data(),
                    h[5] ? pre.data() : nullptr,
                    h[6] ? post.data() : nullptr,
                    h[7] ? sc.data() : nullptr, P, log_n, (int)h[2],
                    (int)h[3], (int)h[4]};
      launch(fr_stage_threads(a), [&] { k_fr_stage(a); });
      fwrite(out.data(), 8, out.size(), stdout);
    } else {
      auto h = take(2);
      const long long N = h[0];
      auto A = take(N * 16);
      std::vector<int64_t> B, C;
      if (h[1]) {
        B = take(N * 16);
        C = take(N * 16);
      }
      auto T = take(16);
      std::vector<int64_t> out(N * 16, -7);
      FrPointwiseArgs a{A.data(), h[1] ? B.data() : nullptr,
                        h[1] ? C.data() : nullptr, T.data(), out.data(), N};
      launch(N, [&] { k_fr_pointwise(a); });
      fwrite(out.data(), 8, out.size(), stdout);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_fr(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: fr_ntt.cu's host build cannot be made")
    d = tmp_path_factory.mktemp("fr_ntt_host")
    with open(os.path.join(CSRC, "fr_ntt.cu")) as f:
        cu = f.read()
    end = "}  // namespace zk"
    (d / "fr_ntt_kernels.cu").write_text(cu[:cu.rindex(end) + len(end)]
                                         + "\n")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", f"-I{CSRC}", f"-I{d}",
                    str(d / "harness.cpp"), "-o", str(exe)], check=True,
                   capture_output=True, text=True)
    return str(exe)


def _run(exe, cases):
    """Run the harness over ``cases`` (lists of int64 arrays) in one
    process; the outputs in order, each shaped as its first array."""
    blob = b"".join(np.ascontiguousarray(p, dtype=np.int64).tobytes()
                    for case in cases for p in case[1])
    res = subprocess.run([exe], input=blob, check=True, capture_output=True)
    words = np.frombuffer(res.stdout, np.int64)
    outs, at = [], 0
    for shape, _ in cases:
        size = int(np.prod(shape))
        outs.append(words[at:at + size].reshape(shape))
        at += size
    assert at == words.size
    return outs


# (name, pre, bitrev, post, post_scalar, in place)
STAGE_MODES = (("plain", 0, 0, 0, 0, 0), ("pre", 1, 0, 0, 0, 0),
               ("bitrev", 0, 1, 0, 0, 0), ("post", 0, 0, 1, 0, 0),
               ("scalar", 0, 0, 0, 1, 0), ("all", 1, 1, 1, 1, 0),
               ("in place", 1, 0, 1, 1, 1))


@pytest.mark.parametrize("dif", [True, False])
@pytest.mark.parametrize("log_n", range(1, 7))
def test_host_stage_matches_stage_plain(host_fr, log_n, dif):
    n = 1 << log_n
    cases, wants = [], []
    for P in (1, 3):
        seed = 100 * log_n + 10 * P + dif
        y = _vals((P, n), seed)
        pw = _vals((n // 2,), seed + 1)
        tabs = _vals((2, n), seed + 2)
        scalar = _vals((), seed + 3)
        for log_h in range(log_n):
            h = 1 << log_h
            for name, pre, br, post, sc, inplace in STAGE_MODES:
                kw = dict(pre=tabs[0] if pre else None, bitrev=bool(br),
                          post=tabs[1] if post else None,
                          post_scalar=scalar if sc else None)
                wants.append(((P, log_h, name), td.stage_plain(
                    y, pw[:: n // (2 * h)], dif, **kw)))
                head = np.array([0, P, log_n, log_h, int(dif), br, pre,
                                 post, sc, inplace])
                parts = [head, y, pw] + [t for t, on in (
                    (tabs[0], pre), (tabs[1], post), (scalar, sc)) if on]
                cases.append(((P, n, 16), [p.numpy() if torch.is_tensor(p)
                                           else p for p in parts]))
    for (key, want), got in zip(wants, _run(host_fr, cases)):
        assert (got == want.numpy()).all(), key


@pytest.mark.parametrize("quotient", [False, True])
@pytest.mark.parametrize("shape", [(3, 8), (3, 300)])
def test_host_pointwise_matches_fieldctx(host_fr, shape, quotient):
    """P5's host build and ``pointwise_plain`` against FieldCtx's own
    products: ``a t`` and ``(a b - c) t`` over 24 and 900 elements (the
    latter four blocks, the last one ragged)."""
    a, b, c = _vals((3,) + shape, 60 + shape[1] + quotient)
    t = _vals((), 70 + shape[1])
    x = FR.sub(FR.mont_mul(a, b), c) if quotient else a
    want = FR.mont_mul(x, t)
    args = (b, c) if quotient else ()
    assert torch.equal(td.pointwise_plain(a, t, *args), want)
    head = np.array([1, a.numel() // 16, int(quotient)])
    parts = [head, a.numpy()] + [v.numpy() for v in args] + [t.numpy()]
    got, = _run(host_fr, [(shape + (16,), parts)])
    assert (got == want.numpy()).all()
