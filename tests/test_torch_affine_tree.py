"""Port parity: the batched-affine bucket tree of ``tpu_zkpool_torch``
(``msm/affine_tree.py``) against ``tpu_zkpool/msm/affine_tree.py``.

On the CPU the K8 wrapper runs its plain twin ``tree_level_plain``, so these
tests hold the twin and the level glue to the JAX functions limb for limb
(the JAX pair add jitted, as its own tests run it; never the Pallas
kernel), and whole ``tree=True`` MSMs to the native Pippenger oracle on the
adversarial cases of ``tests/test_msm_tree.py``. The kernel itself is held
to the twin on the card by ``chip_smoke.py`` and
``test_torch_kernels_cuda.py``. Exact integers throughout: the tolerance is
zero.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool import native_bridge as jnb
from tpu_zkpool.msm import affine_tree as jat

from tpu_zkpool_torch.fields.bn254 import FP_MOD
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.fields.limbs import ints_to_limbs
from tpu_zkpool_torch.msm import affine_tree as tat
from tpu_zkpool_torch.msm import grid as tg

import chip_smoke

torch.set_num_threads(1)


def _affine_rows(pts):
    """Affine int points -> Montgomery rows int64[n, 32] (x, then y)."""
    return torch.as_tensor(FP.to_mont([[x, y] for x, y in pts])) \
        .reshape(len(pts), 32)


def _neg(p):
    return (p[0], (-p[1]) % FP_MOD)


# ----------------------------------------------------------- host index glue

@pytest.mark.parametrize("n,half", [(64, 8), (1024, 4096), (16384, 4096),
                                    (131072, 4096), (4096, 128)])
def test_tree_plan_matches_jax(n, half):
    assert tat.tree_plan(n, half) == jat.tree_plan(n, half)


def _sorted_keys(W, n, half, seed):
    """Seeded sorted bucket keys per row, one row a single fat segment."""
    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, half + 1, (W, n)), axis=1)
    key[0, n // 4:3 * n // 4] = half // 2                 # a fat segment
    key[0] = np.sort(key[0])
    key[-1] = 3                                           # one segment only
    return key


@pytest.mark.parametrize("seed", [1, 2])
def test_segment_index_and_nth_set_match_jax(seed):
    W, n, half = 3, 96, 16
    key = _sorted_keys(W, n, half, seed)
    li_j = np.asarray(jat.segment_local_index(jnp.asarray(key, jnp.int32)))
    li_t = tat.segment_local_index(torch.as_tensor(key))
    assert (li_t.numpy() == li_j).all()
    flags = (li_j & 1) == 0
    for count in (1, 17, n // 2, n):
        pj, vj = jat._nth_set(jnp.asarray(flags), count)
        pt, vt = tat._nth_set(torch.as_tensor(flags), count)
        assert (pt.numpy() == np.asarray(pj)).all()
        assert (vt.numpy() == np.asarray(vj)).all()


# ----------------------------------------------------------- K8's plain twin

@pytest.mark.parametrize("complete", [True, False])
def test_tree_level_plain_matches_jax(complete):
    # P = Q, P = -Q, INF_L, INF_R, both, x equal only, and P = +-Q under
    # INF bits, planted in every 16 pairs
    L, R, fl = chip_smoke.tree_pairs(64, "cpu", seed=21)
    xla = jax.jit(functools.partial(jat.tree_level_xla, complete=complete))
    out_j, inf_j = xla(jnp.asarray(L.numpy().astype(np.uint32)),
                       jnp.asarray(R.numpy().astype(np.uint32)),
                       jnp.asarray(fl.numpy().astype(np.uint32)))
    out_t, inf_t = tat.tree_level_plain(L, R, fl, complete)
    assert (out_t.numpy() == np.asarray(out_j).astype(np.int64)).all()
    assert (inf_t.numpy() == np.asarray(inf_j).astype(np.int64)).all()
    # the planted cases reach both flag values
    assert 0 < int(inf_t.sum()) < 64


def test_bucket_sums_tree_matches_jax():
    W, n, half = 2, 64, 8
    rng = random.Random(31)
    pts = jnb.g1_gen_mul_batch([rng.randrange(1, 1 << 62)
                                for _ in range(W * n)])
    pts = [_neg(p) if rng.randrange(3) == 0 else p for p in pts]
    key = _sorted_keys(W, n, half, 5)
    # inside window 0's fat segment, triples that pair at level 0 whatever
    # the parity: P, P, P (a doubling) and P, -P, P (the infinity)
    s = int(np.nonzero(key[0] == half // 2)[0][0])
    pts[s + 5] = pts[s + 6] = pts[s + 4]
    pts[s + 10] = pts[s + 8]
    pts[s + 9] = _neg(pts[s + 8])
    rows = _affine_rows(pts).reshape(W, n, 32)
    level = functools.partial(jat.tree_level_xla, complete=True)
    jfn = jax.jit(lambda p, k: jat.bucket_sums_tree(
        [p[w] for w in range(W)], k, half, level, True))
    want = np.asarray(jfn(jnp.asarray(rows.numpy().astype(np.uint32)),
                          jnp.asarray(key, jnp.int32))).astype(np.int64)
    got = tat.bucket_sums_tree(rows, torch.as_tensor(key), half, True)
    assert got.shape == (W, half, 3, 1, 16)
    assert (got.numpy() == want).all()


# ------------------------------------------- whole tree=True MSMs vs oracle

N = 1024


@pytest.fixture(scope="module")
def points():
    rng = random.Random(9)
    return jnb.g1_gen_mul_batch([rng.randrange(1, 1 << 62) for _ in range(N)])


def _run_msm(ks, aff, c, nbits=39, complete=False, identity_every=0):
    rows = _affine_rows(aff)
    Z = FP.ones_mont((N,), device="cpu").clone()
    if identity_every:
        Z[::identity_every] = 0
    out = tg.msm_grid_g1((rows[:, :16], rows[:, 16:], Z),
                         torch.as_tensor(ints_to_limbs(ks)), c=c, lanes=32,
                         nbits=nbits, complete=complete, tree=True)
    x, y, z = (int(FP.from_mont(t)) for t in out)
    if z == 0:
        return (0, 0)
    zi = pow(z, -1, FP_MOD)
    return (x * zi * zi % FP_MOD, y * zi ** 3 % FP_MOD)


def _oracle(ks, aff):
    live = [(k, p) for k, p in zip(ks, aff) if k]
    if not live:
        return (0, 0)
    pt = jnb.g1_msm([k for k, _ in live], [p for _, p in live])
    return tuple(pt) if pt is not None else (0, 0)


def test_tree_msm_random_vs_native(points):
    rng = random.Random(10)
    ks = [rng.randrange(0, 1 << 38) for _ in range(N)]
    assert _run_msm(ks, points, c=13) == _oracle(ks, points)


def test_tree_msm_all_equal_scalars_vs_native(points):
    """One bucket segment per window: the worst case of tree_plan."""
    ks = [5] * N
    assert _run_msm(ks, points, c=6) == _oracle(ks, points)


def test_tree_msm_zeros_and_identity_rows_vs_native(points):
    """Zero scalars (every third) and identity rows (Z = 0, every fifth)
    contribute nothing."""
    rng = random.Random(12)
    ks = [0 if i % 3 == 0 else rng.randrange(0, 1 << 38) for i in range(N)]
    live = [0 if i % 5 == 0 else k for i, k in enumerate(ks)]
    assert _run_msm(ks, points, c=6, identity_every=5) == _oracle(live,
                                                                  points)


def test_tree_msm_duplicate_points_complete_vs_native(points):
    """Duplicate points with equal scalars meet in one bucket and pair as a
    doubling, which complete mode handles."""
    rng = random.Random(13)
    aff = [points[i % 16] for i in range(N)]
    ks = [rng.randrange(0, 1 << 38) | 1 for _ in range(N)]
    assert _run_msm(ks, aff, c=6, complete=True) == _oracle(ks, aff)


def test_msm_g2_tree_equals_prefix():
    """G2 takes ``tree=True`` and runs the prefix path, as in JAX."""
    rng = random.Random(14)
    n = 64
    pts = jnb.g2_gen_mul_batch([rng.randrange(1, 1 << 62) for _ in range(n)])
    rows = torch.as_tensor(FP.to_mont(
        [[list(x), list(y), [1, 0]] for x, y in pts]))
    limbs = torch.as_tensor(ints_to_limbs([rng.randrange(1 << 11)
                                           for _ in range(n)]))
    X, Y, Z = rows.unbind(1)
    outs = [tg.msm_grid_g2((X, Y, Z), limbs, c=4, lanes=32, nbits=12,
                           tree=tree) for tree in (False, True)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
