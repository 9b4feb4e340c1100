"""Port parity: the pairing of ``tpu_zkpool_torch.curve`` (``lines``,
``pairing``) against ``tpu_zkpool.curve`` and ``refimpl.pairing_ref``,
exact, and the pairing kernels P1 and P2 (``csrc/pairing.cu``, one warp a
batch element) against their plain versions: each lane program of
``pairing_program`` run on Python ints, then the kernels built with g++,
each warp as 32 threads, over full and partial blocks.

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

The naive pairing (``pairing.miller_loop``, ``pairing_product_is_one``,
``f12_pow_const``) is held to ``refimpl.pairing_ref``, whose affine Miller
loop computes the same value as JAX's ``miller_loop``: that JAX function
jitted at B = 2 compiled for 255 s on a CPU, far above this file's budget.
One batched Miller loop (2 pairs x B = 2) serves every naive case.
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
from tpu_zkpool_torch.curve import pairing_program
from tpu_zkpool_torch.curve import tower as tw
from tpu_zkpool_torch.fields.bn254 import BN_X, FP_MOD as P, FR_MOD

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_zkpool_torch", "csrc")
G1 = (1, 2)
_R = (1 << 256) % P


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


@pytest.fixture(scope="module")
def naive_pairs():
    """``pairing_product_is_one`` at B = 2 over two pairs: element 0 is
    e(P, Q) e(-P, Q), element 1 the perturbed e(P', Q') e(-P', 2 Q').
    Returns (the result, the points, the stacked Miller values the call
    computed)."""
    P0, P1 = pr.g1_mul(3, G1), pr.g1_mul(5, G1)
    Q0, Q1 = pr.g2_mul(7, pr.G2_GEN), pr.g2_mul(11, pr.G2_GEN)
    ps = [[P0, P1], [pr.g1_mul(FR_MOD - 1, P0), pr.g1_mul(FR_MOD - 1, P1)]]
    qs = [[Q0, Q1], [Q0, pr.g2_add(Q1, Q1)]]
    seen = []

    def spy(*args):
        seen.append(naive(*args))
        return seen[-1]

    naive = pairing.miller_loop
    pairing.miller_loop = spy
    try:
        ok = pairing.pairing_product_is_one(
            [pairing.g1_to_limbs(p, "cpu") for p in ps],
            [pairing.g2_to_limbs(q, "cpu") for q in qs])
    finally:
        pairing.miller_loop = naive
    return ok, (ps, qs), seen[0]


def test_naive_pairing_product(naive_pairs):
    ok, _, ml = naive_pairs
    assert ok.tolist() == [True, False] and ok.device.type == "cpu"
    assert ml.shape == (2, 2, 12, 16)


def test_naive_miller_loop_equals_reference(naive_pairs):
    _, (ps, qs), ml = naive_pairs
    for i in range(2):
        assert tw.f12_to_ints(ml[i]) == [pr.miller_loop(p, q)
                                         for p, q in zip(ps[i], qs[i])]
    fe = pairing.final_exponentiation(ml[:, 1].contiguous())
    assert tw.f12_to_ints(fe) == [pr.pairing(ps[i][1], qs[i][1])
                                  for i in range(2)]


def test_f12_pow_const_equals_reference():
    rng = random.Random(64)
    a = tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6))
    t = tw.f12_from_ints([a, pr.F12_ONE], "cpu")
    for e in (0, 1, 0x2D3B):
        assert tw.f12_to_ints(pairing.f12_pow_const(t, e)) == [
            pr.f12_pow(a, e), pr.F12_ONE]


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
#define ZK_HOST_TEST
#define ZK_HOST_THREADS
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
struct ZkDim3 {
  unsigned x, y, z;
};
inline thread_local ZkDim3 threadIdx{0, 0, 0};
inline ZkDim3 blockIdx{0, 0, 0}, blockDim{32, 1, 1};
// one std::barrier a warp of the block (at most 32): __syncwarp waits on
// the calling lane's
inline std::barrier<>* zk_warp[32];
inline void __syncwarp(unsigned = 0xffffffffu) {
  zk_warp[threadIdx.x / 32]->arrive_and_wait();
}
inline uint32_t __shfl_sync(unsigned, uint32_t, int, int = 32) {
  std::abort();  // the pairing kernels shuffle nothing
}
#include "pairing_host.cu"
using namespace zk;
static std::vector<int64_t> rd(size_t n) {
  std::vector<int64_t> v(n);
  if (n && fread(v.data(), 8, n, stdin) != n) std::abort();
  return v;
}
// A launch as the C launchers make it, kWarps warps a block over `batch`
// elements: the blocks one after another, each as kWarps * 32
// std::threads.
template <class F>
static void launch(int batch, F kernel) {
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  for (int w = 0; w < kWarps; ++w) {
    bars.emplace_back(new std::barrier<>(32));
    zk_warp[w] = bars.back().get();
  }
  blockDim.x = 32 * kWarps;
  for (unsigned bx = 0; bx * kWarps < (unsigned)batch; ++bx) {
    blockIdx.x = bx;
    std::vector<std::thread> th;
    for (int t = 0; t < 32 * kWarps; ++t)
      th.emplace_back([&, t] {
        threadIdx.x = t;
        kernel();
      });
    for (auto& x : th) x.join();
  }
}
// mode 0: sizeof(MillerArgs); else the blob (its length, then its words),
// then 1: P1 (legs, B, per leg its stride, px, py and 12 line arrays); 2:
// P2 (B, f). The slots a warp are the launchers' (miller_slots,
// final_exp_slots of the blob's first free slot).
int main() {
  const int64_t mode = rd(1)[0];
  if (mode == 0) {
    printf("%d", (int)sizeof(MillerArgs));
    return 0;
  }
  const std::vector<int64_t> b64 = rd(rd(1)[0]);
  const std::vector<uint32_t> blob(b64.begin(), b64.end());
  const int slots = mode == 1 ? miller_slots((int)blob[0])
                              : final_exp_slots((int)blob[0]);
  if (slots > kHostSlots) std::abort();
  std::vector<int64_t> out;
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
    launch(a.batch,
           [&] { k_miller_lines(a, blob.data(), slots, out.data()); });
  } else {
    const int batch = (int)rd(1)[0];
    std::vector<int64_t> f = rd(192 * batch);
    out.resize(192 * batch);
    launch(batch, [&] {
      k_final_exp(f.data(), blob.data(), slots, out.data(), batch);
    });
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
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread", f"-I{CSRC}",
                    f"-I{d}", "-x", "c++", str(d / "harness.cpp"), "-o",
                    str(exe)], check=True, capture_output=True, text=True)
    return str(exe)


def _run(exe, words, shape):
    out = subprocess.run([exe], input=np.asarray(words, np.int64).tobytes(),
                         capture_output=True, check=True).stdout
    return torch.as_tensor(np.frombuffer(out, np.int64).reshape(shape).copy())


def _head(mode):
    """The harness's words before a kernel's inputs: mode and the lane
    programs' blob, as the wrappers pass it."""
    blob = pairing_program.program()
    return [np.asarray([mode, len(blob)]), blob.astype(np.int64)]


def _host_miller(exe, g1s, legs):
    B = g1s[0][0].shape[0]
    parts = _head(1) + [np.asarray([len(legs), B])]
    for (px, py), lg in zip(g1s, legs):
        parts += [np.asarray([16 if lg.dbl_an0.dim() == 3 else 0]),
                  px.numpy().ravel(), py.numpy().ravel()]
        parts += [t.numpy().ravel() for t in lg]
    return _run(exe, np.concatenate(parts), (B, 12, 16))


def _host_final_exp(exe, f):
    return _run(exe, np.concatenate(_head(2) + [
        [f.shape[0]], f.numpy().ravel()]), tuple(f.shape))


# ------------------------------------------- the lane programs in Python

_RINV = pow(1 << 256, -1, P)


def _interpret(op, slots):
    """Runs lane program ``op`` of the blob on ``slots`` ({slot: Montgomery
    int}) as the kernels read it (``pairing_program``'s format): each
    step's lanes read before any of them writes."""
    blob = pairing_program.program()
    assert blob[1] == pairing_program.FORMAT
    q = int(blob[2 + pairing_program.OPS.index(op)])
    n, q = int(blob[q]), q + 1
    for _ in range(n):
        h = int(blob[q])
        kind, na, nb = h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF
        t = q + 1 + 32

        def comb(base, cnt, k):
            acc = 0
            for j in range(cnt):
                w = int(blob[base + 32 * j + k])
                c = (w >> 16) & 0x7FFF
                acc += (-c if w >> 31 else c) * slots[w & 0xFFFF]
            return acc % P

        new = {}
        for k in range(32):
            x = comb(t, na, k)
            if kind == pairing_program.MUL:
                x = x * comb(t + 32 * na, nb, k) * _RINV % P
            elif kind == pairing_program.INV:
                x = pow(x, -1, P) * _R * _R % P if x else 0
            if blob[q + 1 + k] != pairing_program.NO_DST:
                new[int(blob[q + 1 + k])] = x
        slots.update(new)
        q = t + 32 * (na + nb)


def _mont_ints(t):
    return [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in t]


def _mont_limbs(vals):
    return torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(16)]
                         for x in vals], dtype=torch.int64)


def _plain_op(op, a, b, line):
    if op == "sqr":
        return tw.f12_sqr(a)
    if op == "mul":
        return tw.f12_mul(a, b)
    if op == "line":
        return pairing._line_eval(a, line[4:5], line[5:6], line[0:1],
                                  line[1:2], line[2:3], line[3:4])
    if op == "cyclo":
        return pairing.f12_cyclotomic_sqr(a)
    if op.startswith("frob"):
        return pairing.f12_frobenius(a, int(op[4:]))
    if op == "conj":
        return tw.f12_conj(a)
    return pairing.f12_inv(a)


@pytest.mark.parametrize("op", pairing_program.OPS)
def test_lane_program_equals_plain(op):
    """Each lane program, run on Python ints, computes its plain op: on a
    random Fp12 (the cyclotomic square on a cyclotomic one) and on zero;
    the temporaries start as garbage."""
    rng = random.Random(70 + pairing_program.OPS.index(op))
    vals = [rng.randrange(P) for _ in range(12 + 12 + 6)]
    a, b = _mont_limbs(vals[:12])[None], _mont_limbs(vals[12:24])[None]
    line = _mont_limbs(vals[24:])
    if op == "cyclo":           # f^(p^6 - 1) is cyclotomic
        a = tw.f12_mul(tw.f12_conj(a), pairing.f12_inv(a))
        a = tw.f12_mul(pairing.f12_frobenius(a, 2), a)
    gamma = [c * _R % P for k in (1, 2, 3) for g in pr._gamma(k) for c in g]
    for x in (a, torch.zeros_like(a)):
        slots = {s: rng.randrange(P) for s in range(int(
            pairing_program.program()[0]))}
        slots.update(enumerate(_mont_ints(x[0]), pairing_program.A))
        slots.update(enumerate(_mont_ints(b[0]), pairing_program.B))
        slots.update(enumerate(_mont_ints(line), pairing_program.L))
        slots.update(enumerate(gamma, pairing_program.K))
        _interpret(op, slots)
        got = [slots[pairing_program.A + j] for j in range(12)]
        assert got == _mont_ints(_plain_op(op, x, b, line)[0])


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
    # the lane programs' constants: the bias, p's top word, the slots and
    # the program order of pairing_program
    body = src.split("kBias[9] = {")[1].split("};")[0]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]+)u", body)]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == \
        pr.P << pairing_program.BIAS_LOG2
    assert int(src.split("kPTop = ")[1].split("u;")[0], 16) == pr.P >> 224
    slots = dict(re.findall(r"kSlot(\w) = (\d+)", src))
    assert {k: int(v) for k, v in slots.items()} == dict(
        A=pairing_program.A, B=pairing_program.B, L=pairing_program.L,
        K=pairing_program.K)
    ops = src.split("enum { kSqr")[1].split("}")[0]
    assert ["sqr"] + [o.strip()[1:].lower() for o in ops.split(",")[1:]] \
        == list(pairing_program.OPS)
    assert "kNoDst = 0x%X" % pairing_program.NO_DST in src
    assert "kBlobFormat = 0x%Xu" % pairing_program.FORMAT in src
    assert "kFeRegs = %d;" % pairing.FE_NREG in src


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


@pytest.mark.parametrize("n_legs", [3, 2])
def test_kernel_launch_shapes_on_the_host(host_pairing, three_legs, n_legs):
    """P1 (the 3-leg verify shape, or the 2-leg PoK shape) and P2 over one
    element: the one block's second warp is past the batch and exits
    whole."""
    g1s, legs, _, f, fe = three_legs
    if n_legs == 2:
        legs = [legs[0], legs[0]]
    gb = [(x[:1], y[:1]) for x, y in g1s[:n_legs]]
    lb = [lines.LineArrays(*[t[:, :1].contiguous() if t.dim() == 3 else t
                             for t in lg]) for lg in legs]
    want = f if n_legs == 3 else pairing.miller_loop_lines(gb, lb)
    got = _host_miller(host_pairing, gb, lb)
    assert torch.equal(got, want[:1])
    assert torch.equal(_host_final_exp(host_pairing, got),
                       fe[:1] if n_legs == 3
                       else pairing.final_exponentiation(got))
