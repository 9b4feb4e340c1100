"""K4's twin, ``addn_plain``, in its gathered modes, held limb for limb
(tolerance zero) to the torch passes the grid pipeline ran around K4
before K4 gathered its own operands (copied here), and over Fp to the JAX
package: a jitted ``XlaBackend(1).addn`` after JAX's own ``_take0``,
``jnp.where`` and ``rows_neg_y`` on the same numpy-seeded rows.

``addn(a, b, ia, ib, neg_b, zero)``: out[i] = zeros where zero[i], else
A(i) + B(i), A(i) = a[ia[i]] (a row of zeros where ia[i] < 0), B(i)
likewise, its Y negated where neg_b. Cases: sentinels on either side, the
zero mask, neg_b on rows whose Y is 0, equal operands (the doubling
branch) and opposite ones (the cancelling branch), identities with nonzero
X and Y. The grid pipeline's three gathered calls (the cross-chunk
exclusive prefix, the boundary sums E and the bucket differences B) and
its ``mT`` are held to the code they replace. The kernel itself is held to
the twin on the card by ``chip_smoke.py`` and
``test_torch_kernels_cuda.py``, and on the host through g++ by
``test_torch_k5_scale_add.py``.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.msm import grid as jg

import chip_smoke as cs
from test_torch_msm_grid import _g_points, _jacobian, _neg, _rand_z
from tpu_zkpool_torch.fields.bn254 import FP_MOD
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.msm import grid as tg
from tpu_zkpool_torch.msm import kernels

torch.set_num_threads(1)

N = 48          # rows of each case


@functools.lru_cache(maxsize=None)
def planted(ncomp, n=N, seed=0):
    """{src, other, ia, ib, same, zero}: n point rows with random Z, P = Q
    and P = -Q pairs, identities, identities with nonzero X and Y (rows 5
    mod 16) and Y = 0 (rows 6 mod 16); ``other`` the rows reversed; index
    vectors with -1 at about one in six; ``same`` = 0 .. n - 1; a mask at
    about one in five."""
    rng = random.Random(50 + 7 * seed + ncomp)
    pts = _g_points(ncomp, n, 60 + 7 * seed + ncomp)
    for i in range(0, n - 3, 16):
        pts[i + 1] = pts[i]
        pts[i + 3] = _neg(ncomp, pts[i + 2])
        pts[i + 4] = None
    src = _jacobian(ncomp, pts, [_rand_z(ncomp, rng) for _ in pts])
    src[5::16, :2] = torch.as_tensor(FP.to_mont(
        [[[rng.randrange(1, FP_MOD) for _ in range(ncomp)] for _ in range(2)]
         for _ in range(len(src[5::16]))]))
    src[5::16, 2] = 0
    src[6::16, 1] = 0
    nprng = np.random.default_rng(70 + seed)

    def idx():
        i = nprng.integers(0, n, n)
        return torch.as_tensor(np.where(nprng.random(n) < 1 / 6, -1, i))

    return dict(src=src, other=src.flip(0).contiguous(), ia=idx(),
                ib=idx(), same=torch.arange(n),
                zero=torch.as_tensor(nprng.random(n) < 0.2))


def modes(g):
    """{variant: addn kwargs} over ``planted``'s tensors: the plain mode
    and the gathered modes ``chip_smoke.py`` holds the kernel to."""
    return {"plain": dict(a=g["src"], b=g["other"]), **cs.addn_modes(g)}


MODES = tuple(modes(dict.fromkeys(("src", "other", "ia", "ib", "same",
                                   "zero"))))


def pr7_addn(a, b):
    """K4's twin before this change: the complete add alone."""
    return tg._from_lm(tg._padd(tg._field(a.shape[2]), tg._to_lm(a),
                                tg._to_lm(b)))


def pr7_rows_neg_y(rows):
    out = rows.clone()
    out[:, 1] = FP.neg(rows[:, 1])
    return out


def composed(a, b, ia=None, ib=None, neg_b=False, zero=None):
    """The gathers, selects and negation as torch passes around the plain
    add, as the grid pipeline ran them."""
    if ia is not None:
        a = torch.where((ia < 0)[:, None, None, None], 0,
                        a[ia.clamp(min=0)])
    if ib is not None:
        b = torch.where((ib < 0)[:, None, None, None], 0,
                        b[ib.clamp(min=0)])
    if neg_b:
        b = pr7_rows_neg_y(b)
    out = pr7_addn(a, b)
    if zero is not None:
        out = torch.where(zero[:, None, None, None], 0, out)
    return out


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_addn_gathered_twin_matches_composition(ncomp, mode):
    kw = modes(planted(ncomp))[mode]
    got = kernels.addn(**kw)           # a CPU tensor: the twin
    assert got.shape == (N, 3, ncomp, 16)
    assert torch.equal(got, composed(**kw))
    assert torch.equal(got, tg.addn_plain(**kw))


@functools.lru_cache(maxsize=None)
def _jax_addn():
    """XlaBackend(1).addn, jitted once (~8 s of XLA compile)."""
    return jax.jit(jg.XlaBackend(1).addn)


def _jax_gathered(a, b, ia=None, ib=None, neg_b=False, zero=None):
    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))

    def take(rows, idx):
        if idx is None:
            return rows
        i = jnp.asarray(idx.numpy())
        g = jg._take0(rows, jnp.clip(i, 0, None))
        return jnp.where((i < 0)[:, None, None, None], jnp.zeros_like(g), g)

    A, B = take(u32(a), ia), take(u32(b), ib)
    if neg_b:
        B = jg.rows_neg_y(B)
    out = _jax_addn()(A, B)
    if zero is not None:
        out = jnp.where(jnp.asarray(zero.numpy())[:, None, None, None],
                        jnp.zeros_like(out), out)
    return torch.as_tensor(np.asarray(out).astype(np.int64))


@pytest.mark.parametrize("mode", MODES)
def test_addn_matches_jax_fp(mode):
    kw = modes(planted(1))[mode]
    assert torch.equal(tg.addn_plain(**kw), _jax_gathered(**kw))


def _pool_rows(ncomp, n, rng, pts):
    """n rows drawn from ``pts`` (None = identity) with random Z."""
    pick = [pts[rng.randrange(len(pts))] for _ in range(n)]
    return _jacobian(ncomp, pick, [_rand_z(ncomp, rng) for _ in pick])


@pytest.mark.parametrize("ncomp", [1, 2])
def test_pipeline_calls_match_pr7(ncomp):
    """The grid pipeline's four K4 calls against the code they replace,
    copied from ``_window_sums_one`` and ``_reduce_buckets`` as they stood:
    W = 3 windows, 64 lanes of k = 2 steps, half = 32 buckets, with sorted
    seeded bucket keys (empty buckets and keys 0 included)."""
    W, lanes, k, half = 3, 64, 2, 32
    N_, GA, nq = lanes * k, lanes // 32, half + 2
    rng = random.Random(90 + ncomp)
    pts = _g_points(ncomp, 24, 91 + ncomp) + [None] * 4
    l1 = _pool_rows(ncomp, W * lanes, rng, pts)
    l2 = _pool_rows(ncomp, W * GA, rng, pts)
    prs = _pool_rows(ncomp, W * N_, rng, pts)
    keys = np.random.default_rng(92).integers(0, half // 2, (N_, W)) * 2
    skeys = torch.sort(torch.as_tensor(keys), dim=0)[0]
    dev = torch.device("cpu")
    pt = (3, ncomp, 16)

    # ---- before: gathers, selects and negations in torch, then K4
    starts = torch.searchsorted(skeys.T.contiguous(),
                                torch.arange(nq).expand(W, nq).contiguous())
    wi = torch.arange(W)[:, None]
    idx = (starts - 1).clamp(0, N_ - 1)
    WV = prs[(wi * N_ + idx).reshape(-1)]
    CID = idx // k
    ZM = starts == 0
    ch = torch.arange(lanes)[None, :]
    g, e = ch // 32, ch % 32
    a_idx = ((wi * GA + g) * 32 + (e - 1)).reshape(-1)
    e_mask = (e == 0).expand(W, lanes).reshape(-1)
    a = torch.where(e_mask[:, None, None, None], 0, l1[a_idx.clamp(min=0)])
    b_idx = (wi * GA + (g - 1)).reshape(-1)
    g_mask = (g == 0).expand(W, lanes).reshape(-1)
    b = torch.where(g_mask[:, None, None, None], 0, l2[b_idx.clamp(min=0)])
    excl0 = pr7_addn(a, b)
    ex_at = excl0[(wi * lanes + CID).reshape(-1)]
    E0 = pr7_addn(ex_at, WV).reshape((W, nq) + pt)
    E0 = torch.where(ZM[:, :, None, None, None], 0, E0)
    lo = pr7_rows_neg_y(E0[:, 1:-1].reshape((W * half,) + pt))
    hi = E0[:, 2:].reshape((W * half,) + pt)
    B0 = pr7_addn(hi, lo)
    mT0 = pr7_addn(B0[:W], pr7_rows_neg_y(B0[W:2 * W]))

    # ---- now: K4 gathers, masks and negates
    excl = kernels.addn(l1, l2, *tg.excl_index(W, lanes, dev))
    ex_i, pr_i, zm = tg.boundary_index(skeys, k, lanes, half)
    E = kernels.addn(excl, prs, ex_i, pr_i, zero=zm)
    B = kernels.addn(E, E, *tg.diff_index(W, half, dev), neg_b=True)
    mT = kernels.addn(B[:W], B[W:2 * W], neg_b=True)

    assert bool(ZM.any()) and bool((~ZM).any())
    assert torch.equal(excl, excl0)
    assert torch.equal(E, E0.reshape((W * nq,) + pt))
    assert torch.equal(B, B0)
    assert torch.equal(mT, mT0)
