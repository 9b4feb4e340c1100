"""The H(X) kernels P4 and P5 (``csrc/fr_ntt.cu``): their plain forms
against the JAX package, the kernel route's pass plan on the CPU, and
the kernels built with g++ against the plain forms.

- ``domain.forward_plain`` / ``inverse_plain`` and the pass plan the
  kernel route runs (``domain._passes``: ``pass_plan``'s P4 launches, the
  fused steps at a transform's ends, here over ``pass_plain``, P4's CPU
  form, with 11 stages a pass and with 3) equal ``tpu_zkpool.groth16.domain``
  at n = 16 and 64 on seeded inputs (one jitted JAX call a size), and the
  prover's ``_h_pipeline`` on that plan (the quotient and the demont step
  in the coset inverse's passes) equals JAX's at n = 16 and 64.
- A CPU tensor reaches the plain forms (a spy on them and on P4).
- The host build: ``-DZK_HOST_TEST`` turns ``csrc/fr_ntt.cu``'s CUDA
  keywords into C++ (``field.cuh``'s shims), with a tile of 2^3 values
  (``-DZK_FR_TILE_LOG=3``); the harness runs each block of a launch, shaped
  as the C launcher shapes it (``fr_pass_shape``), as fibers meeting at
  ``__syncthreads`` (``tests/host_fibers.py``). The source is cut before its
  C launchers. P4 at every (h_first, count) of n = 2 ... 64, both
  directions, P = 1 and 3, each fused step alone, the quotient with the
  folded demont scalar and the coset inverse powers, all together and in
  place, with 0, 1 and r - 1 planted in the values and the tables, equals
  ``pass_plain`` (the count = 1 cases are the stages of ``stage_plain``);
  P5, out of place and in place, equals FieldCtx. It skips without g++.
  Exact integers: the tolerance is zero.

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
from tpu_zkpool_torch.fields.limbs import (int_to_limbs, ints_to_limbs,
                                            unpack_limbs16)
from tpu_zkpool_torch.groth16 import domain as td
from tpu_zkpool_torch.groth16 import ntt_kernels as nk
from tpu_zkpool_torch.groth16 import prove as tp

from host_fibers import SHIMS

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
    """The kernel route's plan (``pass_plan``: one pass at 11 stages a
    pass, 2 + 2 or 3 + 3 at 3; the first out of place with the
    bit-reversed read or the coset powers, the rest in place, n^-1 and the
    coset inverse powers on the last) run through P4's CPU form."""
    x, want = _jax_ntt(n)
    monkeypatch.setattr(td, "_plain", lambda t: False)
    for max_pass, passes in ((11, 1), (3, 2)):
        monkeypatch.setattr(nk, "max_pass", lambda device: max_pass)
        assert len(td.pass_plan(n.bit_length() - 1, max_pass)) == passes
        _same(want[fn], getattr(td, fn)(x))


@pytest.mark.parametrize("demont", [False, True])
def test_h_pipeline_on_stage_plan_matches_jax(demont, monkeypatch):
    """The prover's H(X) on the kernel route's plan (P4's and P5's CPU
    forms, 3 stages a pass: two passes a transform, the quotient read by
    the coset inverse's first pass, the demont step folded into its n^-1)
    against JAX's jitted ``_h_pipeline`` at n = 16 and 64, and both
    pipelines of the port."""
    monkeypatch.setattr(nk, "max_pass", lambda device: 3)
    for n in (16, 64):
        evs = _vals((3, n), 77 + n)
        tinv = _vals((), 78, planted=0)
        tables = td.tables(n, "cpu")
        want = jpt._h_pipeline(jnp.asarray(evs.numpy().astype(np.uint32)),
                               jnp.asarray(tinv.numpy().astype(np.uint32)),
                               jd.tables_device(n), demont)
        plain = tp._h_pipeline(evs, tinv, tables, demont)
        _same(want, plain)
        with monkeypatch.context() as m:
            m.setattr(td, "_plain", lambda t: False)
            for pipeline in (tp._h_pipeline, tp._h_pipeline_split):
                got = pipeline(evs, tinv, tables, demont)
                _same(want, got)
                assert torch.equal(got, plain)


def test_cpu_tensors_reach_the_plain_forms(monkeypatch):
    """On a CPU tensor every public function runs the plain forms and P4's
    wrapper never runs; P5's wrapper runs ``pointwise_plain``, P4's
    ``pass_plain``."""
    calls = []

    def spy(name, f):
        def g(*a, **k):
            calls.append(name)
            return f(*a, **k)
        return g

    for name in ("forward_plain", "inverse_plain", "stage_plain",
                 "pass_plain", "pointwise_plain"):
        monkeypatch.setattr(td, name, spy(name, getattr(td, name)))
    monkeypatch.setattr(nk, "fr_pass", spy("fr_pass", nk.fr_pass))
    x = _vals((2, 8), 5)
    for fn in NTT_FNS:
        getattr(td, fn)(x)
    assert calls == ["forward_plain", "inverse_plain", "inverse_plain",
                     "forward_plain", "inverse_plain"]
    calls.clear()
    nk.pointwise(x, _vals((), 6))
    assert calls == ["pointwise_plain"]
    calls.clear()
    nk.fr_pass(x, td.tables(8, "cpu")["words"]["fwd"], 4, 1, True)
    assert calls == ["fr_pass", "pass_plain", "stage_plain"]


def test_tables_power_rows_back_every_stage():
    """``pw`` / ``pw_inv`` rows are the stages' twiddles at stride n/2h:
    each stage is a view of them (no copy) equal to the host tables; the
    packed words P4 reads are those rows and the coset tables, two limbs a
    word."""
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
    for key, rows in (("fwd", t["pw"]), ("inv", t["pw_inv"]),
                      ("coset", t["coset"]), ("coset_inv", t["coset_inv"])):
        w = t["words"][key]
        assert w.dtype == torch.int32 and w.shape == (rows.shape[0], 8)
        assert torch.equal(unpack_limbs16(w), rows)
    assert torch.equal(FR.mont_mul(t["ninv"], t["one"]), t["ninv_demont"])


# ----------------------------------------------- the host build of P4, P5

HOST_TILE_LOG = 3              # -DZK_FR_TILE_LOG: n <= 64 runs as passes

_HARNESS = SHIMS + r"""#include "fr_ntt_kernels.cu"
using namespace zk;

static FrPassArgs g_pass;
static FrPointwiseArgs g_point;
static void pass_thread() { k_fr_pass(g_pass); }
static void point_thread() { k_fr_pointwise(g_point); }

// int64 words (< 2^32) as packed table values, two uint4 each
static std::vector<uint4> words(size_t values) {
  const std::vector<int64_t> w = rd(values * 8);
  std::vector<uint4> v(values * 2);
  uint32_t* p = reinterpret_cast<uint32_t*>(v.data());
  for (size_t i = 0; i < w.size(); ++i) p[i] = (uint32_t)w[i];
  return v;
}

int main() {
  int64_t kind;
  // pass:      0, P, log_n, log_h, count, dif, bitrev, pre, post, scalar,
  //            quotient, inplace, then y, pw words, [pre words],
  //            [post words], [post_scalar], [b, c, t]
  // pointwise: 1, N, in place, then a, t
  while (fread(&kind, 8, 1, stdin) == 1) {
    if (kind == 0) {
      const std::vector<int64_t> h = rd(11);
      const long long P = h[0], n = 1LL << h[1];
      std::vector<int64_t> y = rd(P * n * 16);
      const std::vector<uint4> pw = words(n / 2);
      std::vector<uint4> pre, post;
      std::vector<int64_t> sc, qb, qc, qt;
      if (h[6]) pre = words(n);
      if (h[7]) post = words(n);
      if (h[8]) sc = rd(16);
      if (h[9]) {
        qb = rd(P * n * 16);
        qc = rd(P * n * 16);
        qt = rd(16);
      }
      std::vector<int64_t> out(P * n * 16, -7);
      if (h[10]) out = y;
      const int log_h = (int)h[2], count = (int)h[3], dif = (int)h[4];
      g_pass = FrPassArgs{h[10] ? out.data() : y.data(), out.data(),
                          pw.data(), h[6] ? pre.data() : nullptr,
                          h[7] ? post.data() : nullptr,
                          h[8] ? sc.data() : nullptr,
                          h[9] ? qb.data() : nullptr,
                          h[9] ? qc.data() : nullptr,
                          h[9] ? qt.data() : nullptr, P, (int)h[1],
                          dif ? log_h - count + 1 : log_h, count, dif,
                          (int)h[5]};
      long long blocks;
      int threads, smem;
      if (!fr_pass_shape(g_pass, &blocks, &threads, &smem) ||
          smem > 4 * kFrPassWords)
        std::exit(4);
      for (long long b = 0; b < blocks; ++b) {
        blockIdx.x = (unsigned)b;
        zk_run_block((unsigned)threads, pass_thread);
      }
      fwrite(out.data(), 8, out.size(), stdout);
    } else {
      const std::vector<int64_t> h = rd(2);
      const long long N = h[0];
      const std::vector<int64_t> A = rd(N * 16);
      const std::vector<int64_t> T = rd(16);
      std::vector<int64_t> out(N * 16, -7);
      if (h[1]) out = A;
      g_point = FrPointwiseArgs{h[1] ? out.data() : A.data(), T.data(),
                                out.data(), N};
      for (long long b = 0; b < (N + kFrBlock - 1) / kFrBlock; ++b) {
        blockIdx.x = (unsigned)b;
        zk_run_block(kFrBlock, point_thread);
      }
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
    subprocess.run([gxx, "-std=c++17", "-O1",
                    f"-DZK_FR_TILE_LOG={HOST_TILE_LOG}", f"-I{CSRC}",
                    f"-I{d}", str(d / "harness.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
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


# (name, pre, bitrev, post, post_scalar, quotient, in place); "demont" is
# the coset inverse's steps with the demont scalar n^-1 (plain) folded in
PASS_MODES = (("plain", 0, 0, 0, 0, 0, 0), ("pre", 1, 0, 0, 0, 0, 0),
              ("bitrev", 0, 1, 0, 0, 0, 0), ("post", 0, 0, 1, 0, 0, 0),
              ("scalar", 0, 0, 0, 1, 0, 0), ("quotient", 0, 0, 0, 0, 1, 0),
              ("demont", 0, 0, 1, 1, 1, 0), ("all", 1, 1, 1, 1, 1, 0),
              ("in place", 1, 0, 1, 1, 1, 1))


def _words_np(limbs):
    """Packed words of limbs as int64 (< 2^32) for the harness."""
    return td.pack_words(limbs).numpy().view(np.uint32).astype(np.int64)


@pytest.mark.parametrize("dif", [True, False])
@pytest.mark.parametrize("log_n", range(1, 7))
def test_host_stage_matches_stage_plain(host_fr, log_n, dif):
    """P4's host build (a tile of 2^3 values) against ``pass_plain`` at
    every (h_first, count) of n = 2^log_n, P = 1 and 3, in every mode; the
    count = 1 passes are single stages (``stage_plain``)."""
    n = 1 << log_n
    cases, wants = [], []
    for P in (1, 3):
        seed = 100 * log_n + 10 * P + dif
        y, qb, qc = (_vals((P, n), seed + i) for i in (0, 4, 5))
        pw = _vals((n // 2,), seed + 1)
        tabs = _vals((2, n), seed + 2)
        scalar = _vals((), seed + 3)
        qt = _vals((), seed + 6)
        demont = torch.as_tensor(int_to_limbs(pow(n, -1, R)))
        for count in range(1, min(HOST_TILE_LOG, log_n) + 1):
            for lo in range(log_n - count + 1):
                h_first = 1 << (lo + count - 1 if dif else lo)
                if count == 1:  # a single stage: pass_plain is stage_plain
                    assert torch.equal(
                        td.pass_plain(y, td.pack_words(pw), h_first, 1, dif),
                        td.stage_plain(y, pw[:: n // (2 * h_first)], dif))
                for name, pre, br, post, sc, q, inplace in PASS_MODES:
                    s = demont if name == "demont" else scalar
                    kw = dict(pre=td.pack_words(tabs[0]) if pre else None,
                              bitrev=bool(br),
                              post=td.pack_words(tabs[1]) if post else None,
                              post_scalar=s if sc else None,
                              quotient=(qb, qc, qt) if q else None)
                    wants.append(((P, count, h_first, name), td.pass_plain(
                        y, td.pack_words(pw), h_first, count, dif, **kw)))
                    head = np.array([0, P, log_n, h_first.bit_length() - 1,
                                     count, int(dif), br, pre, post, sc, q,
                                     inplace])
                    parts = [head, y.numpy(), _words_np(pw)]
                    parts += [_words_np(t) for t, on in (
                        (tabs[0], pre), (tabs[1], post)) if on]
                    parts += [s.numpy()] if sc else []
                    parts += [qb.numpy(), qc.numpy(), qt.numpy()] if q else []
                    cases.append(((P, n, 16), parts))
    for (key, want), got in zip(wants, _run(host_fr, cases)):
        assert (got == want.numpy()).all(), key


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("shape", [(3, 8), (3, 300)])
def test_host_pointwise_matches_fieldctx(host_fr, shape, in_place):
    """P5's host build and ``pointwise_plain`` against FieldCtx's own
    product ``a t`` over 24 and 900 elements (the latter four blocks, the
    last one ragged), out of place and in place (``out`` is ``a``, as the
    prover's R^2 step runs it)."""
    a = _vals(shape, 60 + shape[1] + in_place)
    t = _vals((), 70 + shape[1])
    want = FR.mont_mul(a, t)
    assert torch.equal(td.pointwise_plain(a, t), want)
    assert torch.equal(nk.pointwise(a.clone(), t), want)
    head = np.array([1, a.numel() // 16, int(in_place)])
    got, = _run(host_fr, [(shape + (16,), [head, a.numpy(), t.numpy()])])
    assert (got == want.numpy()).all()


def test_kernel_route_takes_only_its_own_tables(monkeypatch):
    """The kernel route reads the packed words ``tables`` made once: a
    table of the caller's that is not the tables' own entry raises rather
    than being packed anew on every call; a quotient needs a transform's
    first pass, so n = 1 raises on both routes."""
    monkeypatch.setattr(td, "_plain", lambda t: False)
    monkeypatch.setattr(nk, "max_pass", lambda device: 3)
    x = _vals((2, 16), 9)
    t = td.tables(16, "cpu")
    assert torch.equal(td.forward(x, t["fwd"]), td.forward_plain(x))
    copies = dict(fwd=tuple(w.clone() for w in t["fwd"]),
                  inv=tuple(w.clone() for w in t["inv"]),
                  coset=t["coset"].clone(), coset_inv=t["coset_inv"].clone())
    for call in (lambda: td.forward(x, copies["fwd"]),
                 lambda: td.inverse(x, copies["inv"]),
                 lambda: td.coset_forward(x, copies["coset"]),
                 lambda: td.coset_inverse(x, copies["coset_inv"])):
        with pytest.raises(ValueError, match="own tables"):
            call()
    one = _vals((2, 1), 10)
    for plain in (False, True):
        monkeypatch.setattr(td, "_plain", lambda t: plain)
        with pytest.raises(ValueError, match="n >= 2"):
            td.coset_inverse(one, quotient=(one, one, one[0, 0]))
