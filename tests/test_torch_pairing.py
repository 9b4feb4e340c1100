"""Port parity: the pairing of ``tpu_zkpool_torch.curve`` (``lines``,
``pairing``) against ``tpu_zkpool.curve`` and ``refimpl.pairing_ref``,
exact, and the pairing kernels P1 and P2 (``csrc/pairing.cu``) built with
g++ against their plain versions.

- ``LineArrays`` equal JAX ``lines.precompute_g2_lines(_batch)`` limb for
  limb;
- ``f12_frobenius`` and ``f12_cyclotomic_sqr`` equal the JAX functions
  (jitted: ~4 and ~10 s to compile); ``f12_inv`` (whose JAX form compiles
  for ~60 s) and ``f12_pow_x_cyclo`` equal the refimpl values in the JAX
  Montgomery encoding;
- the plain Miller loop over 3 legs (two fixed, one batched), then the
  plain final exponentiation, equal the refimpl product of pairings, and
  the final exponentiation equals refimpl's naive (p^12 - 1)/r power.

The JAX ``miller_loop_lines``, ``final_exponentiation`` and ``_ppl_jit`` are
never jitted here: they compile for minutes.
"""

import ctypes
import os
import random
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.curve import lines as jlines
from tpu_zkpool.curve import pairing_jax as jpj
from tpu_zkpool.fields.fctx import FP as JFP
from tpu_zkpool.refimpl import pairing_ref as pr

from tpu_zkpool_torch.curve import lines, pairing, pairing_kernels
from tpu_zkpool_torch.curve import tower as tw
from tpu_zkpool_torch.fields.bn254 import BN_X, FR_MOD

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_zkpool_torch", "csrc")
G1 = (1, 2)


def _limbs(vals):
    flat = [[x for c in v for x in c] for v in vals]
    return JFP.to_mont(np.asarray(flat, dtype=object)).astype(np.int64)


def _jax_f12(t):
    return tuple((jnp.asarray(t[:, 2 * i].numpy().astype(np.uint32)),
                  jnp.asarray(t[:, 2 * i + 1].numpy().astype(np.uint32)))
                 for i in range(6))


def _from_jax(f):
    return np.stack([np.asarray(c) for pair in f for c in pair],
                    1).astype(np.int64)


def _g2(rng):
    return pr.g2_mul(rng.randrange(1, FR_MOD), pr.G2_GEN)


def _g1(rng):
    return pr.g1_mul(rng.randrange(1, FR_MOD), G1)


@pytest.fixture(scope="module")
def three_legs():
    """Two fixed legs and one batched leg over B = 2 proofs: the verify's
    shape. Returns (g1s, legs, points, plain Miller f, plain final exp)."""
    rng = random.Random(61)
    B = 2
    q1, q2 = _g2(rng), _g2(rng)
    qb = [_g2(rng) for _ in range(B)]
    ps = [[_g1(rng) for _ in range(B)] for _ in range(3)]
    legs = [lines.precompute_g2_lines_batch(qb, device="cpu"),
            lines.precompute_g2_lines(q1, device="cpu"),
            lines.precompute_g2_lines(q2, device="cpu")]
    g1s = [pairing.g1_to_limbs(p, "cpu") for p in ps]
    f = pairing.miller_loop_lines(g1s, legs)
    fe = pairing.final_exponentiation(f)
    qs = [qb, [q1] * B, [q2] * B]
    return g1s, legs, (ps, qs), f, fe


def test_line_arrays_equal_jax():
    rng = random.Random(62)
    q = _g2(rng)
    qs = [_g2(rng) for _ in range(3)]
    for got, want in ((lines.precompute_g2_lines(q, device="cpu"),
                       jlines.precompute_g2_lines(q)),
                      (lines.precompute_g2_lines_batch(qs, device="cpu"),
                       jlines.precompute_g2_lines_batch(qs)),
                      (lines.precompute_g2_lines_batch(qs[:1], device="cpu"),
                       jlines.precompute_g2_lines_batch(qs[:1]))):
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert g.dtype == torch.int64 and g.is_contiguous()
            assert (g.numpy() == np.asarray(w).astype(np.int64)).all()
    assert lines.ATE_BITS == jlines.ATE_BITS
    assert lines.g2_line_schedules_batch(qs) == \
        jlines.g2_line_schedules_batch(qs)


def test_batch_f2_inv_zero_norm_guard():
    rng = random.Random(63)
    ds = [(rng.randrange(pr.P), rng.randrange(pr.P)) for _ in range(5)]
    invs, zero = lines._batch_f2_inv(ds)
    assert zero == [] and invs == [pr.f2_inv(d) for d in ds]
    # one zero denominator: the others stay exact (the reference's
    # unguarded running product would zero every inverse)
    ds[2] = (0, 0)
    invs, zero = lines._batch_f2_inv(ds)
    assert zero == [2] and invs[2] == (0, 0)
    assert [x for i, x in enumerate(invs) if i != 2] == \
        [pr.f2_inv(d) for i, d in enumerate(ds) if i != 2]
    assert jlines._batch_f2_inv(ds) == [(0, 0)] * 5
    # a B point with y = 0 meets a zero denominator at the first doubling
    bad = set()
    q = _g2(rng)
    sched = lines.g2_line_schedules_batch([q, (q[0], (0, 0)), q], bad)
    assert bad == {1} and sched[0] == sched[2] == lines.g2_line_schedule(q)
    with pytest.raises(ValueError, match=r"points \[1\]"):
        lines.precompute_g2_lines_batch([q, (q[0], (0, 0)), q], device="cpu")


def test_frobenius_and_cyclotomic_sqr_equal_jax():
    rng = random.Random(64)
    a = [tuple((rng.randrange(pr.P), rng.randrange(pr.P)) for _ in range(6))
         for _ in range(2)]
    ta = torch.as_tensor(_limbs(a))
    ja = _jax_f12(ta)
    want = jax.jit(lambda x: tuple(jpj.f12_frobenius(x, k)
                                   for k in (1, 2, 3)))(ja)
    for k, w in zip((1, 2, 3), want):
        assert (pairing.f12_frobenius(ta, k).numpy() == _from_jax(w)).all()
        assert tw.f12_to_ints(pairing.f12_frobenius(ta, k)) == \
            [pr.f12_frobenius(x, k) for x in a]
    got = pairing.f12_cyclotomic_sqr(ta)
    assert (got.numpy() == _from_jax(jax.jit(jpj.f12_cyclotomic_sqr)(ja))
            ).all()


def test_inverse_and_pow_x_equal_reference(three_legs):
    _, _, _, f, _ = three_legs
    vals = tw.f12_to_ints(f)
    inv = pairing.f12_inv(f)
    assert (inv.numpy() == _limbs([pr.f12_inv(v) for v in vals])).all()
    assert tw.f12_eq_one(tw.f12_mul(f, inv)).all()
    # the cyclotomic element of the easy part, then a^x by cyclotomic squares
    m = tw.f12_mul(tw.f12_conj(f), inv)
    m = tw.f12_mul(pairing.f12_frobenius(m, 2), m)
    mv = tw.f12_to_ints(m[:1])
    assert tw.f12_to_ints(pairing.f12_cyclotomic_sqr(m[:1])) == \
        [pr.f12_mul(mv[0], mv[0])]
    assert tw.f12_to_ints(pairing.f12_pow_x_cyclo(m[:1])) == \
        [pr.f12_pow_x_cyclo(mv[0])] == [pr.f12_pow(mv[0], BN_X)]


def test_fe_program_is_jax_program():
    assert (pairing.FE_PROGRAM == jpj._fe_program()).all()
    assert (pairing.FE_NREG, pairing.FE_OUT) == (jpj._FE_NREG, jpj._FE_OUT)


def test_plain_pairing_equals_reference(three_legs):
    g1s, legs, (ps, qs), f, fe = three_legs
    B = f.shape[0]
    ml = [pr.f12_mul(pr.f12_mul(pr.miller_loop(ps[0][i], qs[0][i]),
                                pr.miller_loop(ps[1][i], qs[1][i])),
                     pr.miller_loop(ps[2][i], qs[2][i])) for i in range(B)]
    assert tw.f12_to_ints(f) == ml
    assert tw.f12_to_ints(fe) == [pr.final_exponentiation_fast(v)
                                  for v in ml]
    assert tw.f12_to_ints(fe[:1]) == [pr.final_exponentiation(ml[0])]
    target = pr.f12_mul(pr.pairing(ps[0][0], qs[0][0]),
                        pr.f12_mul(pr.pairing(ps[1][0], qs[1][0]),
                                   pr.pairing(ps[2][0], qs[2][0])))
    assert tw.f12_to_ints(fe[:1]) == [target]


_HARNESS = r"""
#include <cstdio>
#include <cstdint>
#include <vector>
#include "pairing_host.cu"
using namespace zk;
static std::vector<int64_t> rd(size_t n) {
  std::vector<int64_t> v(n);
  if (fread(v.data(), 8, n, stdin) != n) std::abort();
  return v;
}
// mode 0: sizeof(MillerArgs); 1: P1 (legs, B, per leg its stride, px, py
// and 12 line arrays); 2: P2 (B, f). Blocks of
// kPairThreads threads run one thread after another.
int main() {
  const int64_t mode = rd(1)[0];
  std::vector<int64_t> out;
  if (mode == 0) {
    printf("%d", (int)sizeof(MillerArgs));
    return 0;
  }
  blockDim.x = kPairThreads;
  if (mode == 1) {
    std::vector<int64_t> h = rd(2);
    MillerArgs a{};
    a.legs = (int)h[0];
    a.batch = (int)h[1];
    std::vector<std::vector<int64_t>> keep;
    keep.reserve(64);
    for (int l = 0; l < a.legs; ++l) {
      a.stride[l] = rd(1)[0];
      keep.push_back(rd(16 * a.batch));
      a.px[l] = keep.back().data();
      keep.push_back(rd(16 * a.batch));
      a.py[l] = keep.back().data();
      for (int k = 0; k < 12; ++k) {
        const size_t S = k < 8 ? kAteSteps : 2;
        keep.push_back(rd(S * (a.stride[l] ? a.batch : 1) * 16));
        a.line[l][k] = keep.back().data();
      }
    }
    out.resize(192 * a.batch);
    for (unsigned bx = 0; bx * kPairThreads < (unsigned)a.batch; ++bx)
      for (unsigned t = 0; t < kPairThreads; ++t) {
        blockIdx.x = bx;
        threadIdx.x = t;
        k_miller_lines(a, out.data());
      }
  } else {
    const int batch = (int)rd(1)[0];
    std::vector<int64_t> f = rd(192 * batch);
    out.resize(192 * batch);
    for (unsigned bx = 0; bx * kPairThreads < (unsigned)batch; ++bx)
      for (unsigned t = 0; t < kPairThreads; ++t) {
        blockIdx.x = bx;
        threadIdx.x = t;
        k_final_exp(f.data(), out.data(), batch);
      }
  }
  fwrite(out.data(), 8, out.size(), stdout);
}
"""


@pytest.fixture(scope="module")
def host_pairing(tmp_path_factory):
    """pairing.cu built with g++ -DZK_HOST_TEST: the source cut at the end
    of its namespace (the launchers follow), without <cuda_runtime.h>."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: pairing.cu's host build cannot be made")
    d = tmp_path_factory.mktemp("pairing_host")
    with open(os.path.join(CSRC, "pairing.cu")) as f:
        src = f.read()
    end = "}  // namespace zk"
    src = src[:src.rindex(end) + len(end)].replace(
        "#include <cuda_runtime.h>\n", "")
    (d / "pairing_host.cu").write_text(src + "\n")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", "-DZK_HOST_TEST", f"-I{CSRC}",
                    f"-I{d}", "-x", "c++", str(d / "harness.cpp"), "-o",
                    str(exe)], check=True, capture_output=True, text=True)
    return str(exe)


def _run(exe, words, shape):
    out = subprocess.run([exe], input=np.asarray(words, np.int64).tobytes(),
                         capture_output=True, check=True).stdout
    return torch.as_tensor(np.frombuffer(out, np.int64).reshape(shape).copy())


def _host_miller(exe, g1s, legs):
    B = g1s[0][0].shape[0]
    parts = [np.asarray([1, len(legs), B])]
    for (px, py), lg in zip(g1s, legs):
        parts += [np.asarray([16 if lg.dbl_an0.dim() == 3 else 0]),
                  px.numpy().ravel(), py.numpy().ravel()]
        parts += [t.numpy().ravel() for t in lg]
    return _run(exe, np.concatenate(parts), (B, 12, 16))


def _host_final_exp(exe, f):
    return _run(exe, np.concatenate([[2, f.shape[0]], f.numpy().ravel()]),
                tuple(f.shape))


def test_kernel_source_constants():
    with open(os.path.join(CSRC, "pairing.cu")) as f:
        src = f.read()
    bits = int(src.split("kAteBits = ")[1].split("ull")[0], 16)
    assert [(bits >> (63 - s)) & 1 for s in range(64)] == lines.ATE_BITS
    bn_x = int(src.split("kBnX = ")[1].split("ull")[0], 16)
    n_bits = int(src.split("kBnXBits = ")[1].split(";")[0])
    assert bn_x == BN_X and n_bits == BN_X.bit_length()
    body = src.split("kGamma[3][6][2][8] = {")[1].split("};")[0]
    words = [int(w, 16) for w in
             re.findall(r"0x([0-9a-f]+)u", re.sub(r"//[^\n]*", "", body))]
    vals = [sum(w << (32 * i) for i, w in enumerate(words[k:k + 8]))
            for k in range(0, len(words), 8)]
    R = 1 << 256
    want = [c * R % pr.P for k in (1, 2, 3) for g in pr._gamma(k)
            for c in g]
    assert vals == want


def test_kernels_on_the_host_equal_plain(host_pairing, three_legs):
    g1s, legs, _, f, fe = three_legs
    exe = host_pairing
    size = subprocess.run([exe], input=np.asarray([0], np.int64).tobytes(),
                          capture_output=True, check=True).stdout
    assert int(size) == ctypes.sizeof(pairing_kernels.MillerArgs)
    assert torch.equal(_host_miller(exe, g1s, legs), f)
    # the PoK shape: two batched legs
    two = [legs[0], legs[0]]
    assert torch.equal(_host_miller(exe, g1s[:2], two),
                       pairing.miller_loop_lines(g1s[:2], two))
    assert torch.equal(_host_final_exp(exe, f), fe)
    rng = random.Random(66)
    rnd = torch.as_tensor(_limbs(
        [pr.F12_ONE, ((0, 0),) * 6]
        + [tuple((rng.randrange(pr.P), rng.randrange(pr.P))
                 for _ in range(6))]))
    assert torch.equal(_host_final_exp(exe, rnd),
                       pairing.final_exponentiation(rnd))
