"""Port parity: the grid MSM of ``tpu_zkpool_torch`` against the JAX package.

On the CPU every kernel wrapper runs its plain twin, so these tests hold the
twins (the arithmetic the CUDA kernels repeat) to the JAX point formulas
limb for limb, each twin to a pure-int oracle, and whole MSMs to the native
Pippenger oracle. The kernels themselves are held to the twins on the card
by ``chip_smoke.py`` and ``test_torch_kernels_cuda.py``. Exact integers
throughout: the tolerance is zero.
"""

import random

import numpy as np
import pytest
import torch

from tpu_zkpool import native_bridge as jnb
from tpu_zkpool.fields import fctx as jfctx
from tpu_zkpool.fields.limbs import ints_to_limbs as j_ints_to_limbs
from tpu_zkpool.msm import grid as jg

from tpu_zkpool_torch.fields.bn254 import FP_MOD, FR_MOD
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.fields.limbs import ints_to_limbs
from tpu_zkpool_torch.msm import grid as tg
from tpu_zkpool_torch.refimpl import pairing_ref as pr

torch.set_num_threads(1)


# ------------------------------------------------------------------ helpers

def _g_points(ncomp, n, seed):
    rng = random.Random(seed)
    ks = [rng.randrange(1, FR_MOD) for _ in range(n)]
    if ncomp == 1:
        return jnb.g1_gen_mul_batch(ks)
    return jnb.g2_gen_mul_batch(ks)


def _jacobian(ncomp, pts, zs):
    """Affine points with chosen Z -> rows int64[n, 3, ncomp, 16] (Z = 0
    rows for None)."""
    rows = []
    for p, z in zip(pts, zs):
        if p is None:
            rows.append([[0] * ncomp] * 3)
            continue
        if ncomp == 1:
            x, y = p
            rows.append([[x * z * z % FP_MOD], [y * z ** 3 % FP_MOD], [z]])
        else:
            x, y = p
            z2 = pr.f2_mul(z, z)
            rows.append([list(pr.f2_mul(x, z2)),
                         list(pr.f2_mul(y, pr.f2_mul(z2, z))), list(z)])
    return torch.as_tensor(FP.to_mont(rows))


def _affine(ncomp, row):
    """(3, ncomp, 16) Jacobian Montgomery row -> affine ints or None."""
    c = FP.from_mont(row)
    if ncomp == 1:
        x, y, z = (int(c[i, 0]) for i in range(3))
        if z == 0:
            return None
        zi = pow(z, -1, FP_MOD)
        return (x * zi * zi % FP_MOD, y * zi ** 3 % FP_MOD)
    X, Y, Z = (tuple(int(v) for v in c[i]) for i in range(3))
    if Z == (0, 0):
        return None
    zi = pr.f2_inv(Z)
    zi2 = pr.f2_mul(zi, zi)
    return (pr.f2_mul(X, zi2), pr.f2_mul(Y, pr.f2_mul(zi2, zi)))


def _add(ncomp, a, b):
    return pr.g1_add(a, b) if ncomp == 1 else pr.g2_add(a, b)


def _neg(ncomp, p):
    if p is None:
        return None
    return (p[0], (-p[1]) % FP_MOD) if ncomp == 1 else pr.g2_neg(p)


def _mul(ncomp, k, p):
    return pr.g1_mul(k, p) if ncomp == 1 else pr.g2_mul(k, p)


def _rand_z(ncomp, rng):
    if ncomp == 1:
        return rng.randrange(1, FP_MOD)
    return (rng.randrange(1, FP_MOD), rng.randrange(FP_MOD))


# ---------------------------------------------------- point formula parity

def _formula_inputs(ncomp):
    """Jacobian P, Q rows covering generic pairs, P = Q (other Z), P = -Q,
    P = O, Q = O and O + O; and affine rows Qa (Z = 1, never O) pairing P
    with P = Q, P = -Q and P = O cases. One batch size throughout, so the
    JAX side compiles each primitive once."""
    rng = random.Random(11 + ncomp)
    pts = _g_points(ncomp, 6, 100 + ncomp)
    P = [pts[0], pts[1], pts[2], pts[3], None, pts[4], None]
    Q = [pts[5], pts[1], _neg(ncomp, pts[2]), None, pts[3], pts[4], None]
    Qa = [pts[5], pts[1], _neg(ncomp, pts[2]), pts[0], pts[3], pts[4],
          pts[2]]
    zp = [_rand_z(ncomp, rng) for _ in P]
    zq = [_rand_z(ncomp, rng) for _ in Q]
    one = [1 if ncomp == 1 else (1, 0)] * len(Qa)
    return (_jacobian(ncomp, P, zp), _jacobian(ncomp, Q, zq),
            _jacobian(ncomp, Qa, one))


@pytest.fixture
def jax_unrolled(monkeypatch):
    """The JAX formulas on the unrolled FieldCtx (same math as ``FP``, no
    lax.scan per op), so they run eagerly in seconds on the CPU."""
    monkeypatch.setattr(jg, "FP", jfctx.FP_U)
    return jg


def _jax_pt(rows, C=3):
    a = rows.numpy().astype(np.uint32)
    return tuple(a[:, i] for i in range(C))


def _port_pt(rows, C=3):
    return tg._to_lm(rows[:, :C])


def _cmp(jax_out, port_out):
    want = np.stack([np.asarray(v) for v in jax_out], 1).astype(np.int64)
    got = tg._from_lm(port_out).numpy()
    assert (got == want).all()


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("formula,complete", [
    ("pdouble", True), ("pmadd", True), ("pmadd", False),
    ("padd", True), ("padd", False)])
def test_point_formulas_match_jax(jax_unrolled, ncomp, formula, complete):
    jg_ = jax_unrolled
    P, Q, Qa = _formula_inputs(ncomp)
    JF, TF = jg_._xfield(ncomp), tg._field(ncomp)
    if formula == "pdouble":
        _cmp(jg_._pdouble(JF, _jax_pt(P)), tg._pdouble(TF, _port_pt(P)))
        return
    if formula == "pmadd":
        _cmp(jg_._pmadd(JF, _jax_pt(P), _jax_pt(Qa, 2), complete),
             tg._pmadd(TF, _port_pt(P), _port_pt(Qa, 2), complete))
        return
    _cmp(jg_._padd(JF, _jax_pt(P), _jax_pt(Q), complete),
         tg._padd(TF, _port_pt(P), _port_pt(Q), complete))


# ----------------------------------------------------------- signed digits

@pytest.mark.parametrize("c,nbits", [(13, 255), (14, 255), (13, 64)])
def test_signed_digits_match_jax(c, nbits):
    rng = random.Random(c + nbits)
    top = FR_MOD if nbits == 255 else 1 << (nbits - 1)
    ks = [rng.randrange(top) for _ in range(64)] + [0, 1, top - 1]
    jb, jn = jg.signed_digits(np.asarray(j_ints_to_limbs(ks)), c, nbits)
    tb, tn = tg.signed_digits(torch.as_tensor(ints_to_limbs(ks)), c, nbits)
    assert (tb.numpy() == np.asarray(jb).astype(np.int64)).all()
    assert (tn.numpy() == np.asarray(jn)).all()
    for i, k in enumerate(ks):
        assert sum((-1 if tn[i, w] else 1) * int(tb[i, w]) << (c * w)
                   for w in range(tb.shape[1])) == k


# ------------------------------------------- plain twins vs pure-int oracle

def _affine_rows(ncomp, rows):
    flat = rows.reshape(-1, 3, ncomp, 16)
    return [_affine(ncomp, r) for r in flat]


def _stage_points(ncomp, n, seed):
    """Jacobian rows of n points (one identity, one repeated pair) and
    their affine values."""
    rng = random.Random(seed)
    pts = _g_points(ncomp, n, seed)
    pts[1] = None
    pts[3] = pts[2]
    rows = _jacobian(ncomp, pts, [_rand_z(ncomp, rng) for _ in pts])
    return rows, pts


@pytest.mark.parametrize("ncomp", [1, 2])
def test_prefix_rows_plain_vs_oracle(ncomp):
    k, lanes = 3, 4
    pts = _g_points(ncomp, k * lanes, 7)
    pts[5] = pts[1]                       # P + P in lane 1 (steps 0, 1)
    pts[6] = _neg(ncomp, pts[2])          # P = -Q in lane 2
    rows = _jacobian(ncomp, pts, [1 if ncomp == 1 else (1, 0)] * len(pts))
    xy = rows[:, :2].contiguous()
    signs = torch.tensor([[0, 0, 0, 1], [0, 0, 0, 1], [1, 0, 1, 0]])
    # window 0 reads row j * lanes + l at step j of lane l; window 1 the
    # same rows with every sign flipped
    index = torch.arange(k * lanes).reshape(k, lanes)
    payload = torch.stack([index | (signs << 31),
                           index | ((1 - signs) << 31)])
    out = tg.prefix_rows_plain(xy, payload, complete=True)
    assert out.shape == (2, k * lanes, 3, ncomp, 16)
    for w in range(2):
        got = _affine_rows(ncomp, out[w])
        acc = [None] * lanes
        for j in range(k):
            for l in range(lanes):
                p = pts[j * lanes + l]
                acc[l] = _add(ncomp, acc[l],
                              _neg(ncomp, p) if signs[j, l] != w else p)
                assert got[l * k + j] == acc[l], (w, j, l)


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("mixed", [True, False])
def test_prefix_plain_vs_oracle(ncomp, mixed):
    k, lanes = 3, 2
    if mixed:
        pts = _g_points(ncomp, k * lanes, 9)
        rows = _jacobian(ncomp, pts, [1 if ncomp == 1 else (1, 0)] * len(pts))
        tiles = rows[:, :2].reshape(k, lanes, 2, ncomp, 16).contiguous()
    else:
        rows, pts = _stage_points(ncomp, k * lanes, 9)
        tiles = rows.reshape(k, lanes, 3, ncomp, 16)
    got = _affine_rows(ncomp, tg.prefix_plain(tiles, mixed, True))
    acc = [None] * lanes
    for j in range(k):
        for l in range(lanes):
            acc[l] = _add(ncomp, acc[l], pts[j * lanes + l])
            assert got[j * lanes + l] == acc[l]


@pytest.mark.parametrize("ncomp", [1, 2])
def test_wsum_addn_scale_add_horner_plain_vs_oracle(ncomp):
    L, lanes = 4, 2
    rows, pts = _stage_points(ncomp, L * lanes, 13)
    acc_tot = _affine_rows(ncomp, tg.wsum_plain(
        rows.reshape(L, lanes, 3, ncomp, 16)))
    for l in range(lanes):
        acc = tot = None
        for j in range(L):
            p = pts[j * lanes + l]
            acc = _add(ncomp, acc, p)
            tot = _add(ncomp, tot, _mul(ncomp, j + 1, p) if p else None)
        assert acc_tot[l] == acc and acc_tot[lanes + l] == tot

    a, b = rows[:4], rows[4:].clone()
    b[2] = a[2]                           # a = b: the doubling branch
    pa = _affine_rows(ncomp, a)
    pb = _affine_rows(ncomp, b)
    assert _affine_rows(ncomp, tg.addn_plain(a, b)) == [
        _add(ncomp, x, y) for x, y in zip(pa, pb)]
    assert _affine_rows(ncomp, tg.scale_add_plain(a, b, 3)) == [
        _add(ncomp, _mul(ncomp, 8, x) if x else None, y)
        for x, y in zip(pa, pb)]
    c = 5
    want = None
    for w, p in enumerate(pa):
        if p is not None:
            want = _add(ncomp, want, _mul(ncomp, 1 << (c * w), p))
    assert _affine(ncomp, tg.horner_plain(a, c)) == want


# ----------------------------------------------- whole MSMs vs native oracle

def _msm_inputs(ncomp, n, nbits, seed):
    rng = random.Random(seed)
    pts = _g_points(ncomp, n, seed)
    for i in (3, 10, n - 1):
        pts[i] = None                     # identity rows
    pts[5] = pts[6]                       # a repeated point
    top = FR_MOD if nbits == 255 else 1 << (nbits - 1)
    ks = [rng.randrange(top) for _ in range(n)]
    ks[7] = 0
    rows = _jacobian(ncomp, pts, [1 if ncomp == 1 else (1, 0)] * n)
    return pts, ks, rows


@pytest.mark.parametrize("ncomp,n,c,nbits,lanes,sub_log2", [
    (1, 1024, 13, 27, 64, 17),     # C = 32 > 1: the two-level reduction
    (1, 4096, 5, 20, 32, 10),      # four sub-slices folded through addn
    (2, 1024, 6, 24, 32, 17),      # G2 (Fp2)
])
def test_msm_grid_vs_native(ncomp, n, c, nbits, lanes, sub_log2):
    pts, ks, rows = _msm_inputs(ncomp, n, nbits, 40 + n + c)
    X, Y, Z = rows.unbind(1)
    msm = tg.msm_grid_g1 if ncomp == 1 else tg.msm_grid_g2
    if ncomp == 1:
        X, Y, Z = X[:, 0], Y[:, 0], Z[:, 0]
    out = msm((X, Y, Z), torch.as_tensor(ints_to_limbs(ks)), c=c,
              lanes=lanes, nbits=nbits, sub_log2=sub_log2)
    got = _affine(ncomp, torch.stack([o.reshape(ncomp, 16) for o in out]))
    pairs = [(k, p) for k, p in zip(ks, pts) if p is not None and k]
    oracle = jnb.g1_msm if ncomp == 1 else jnb.g2_msm
    assert got == oracle([k for k, _ in pairs], [p for _, p in pairs])
