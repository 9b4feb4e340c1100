"""K2's twin, ``prefix_plain``, against the JAX package and a pure-int oracle.

The twin follows the kernel's warp schedule (``prefix_schedule``: T
segments a lane, each scanned serially, a Kogge-Stone scan of the segment
totals, then a carry add into each segment), so its Jacobian limbs differ
from JAX's serial scan (``XlaBackend.prefix``, one add after another); both
are compared in affine form, exactly (tolerance zero). The kernel itself is
held to the twin limb for limb on the card by ``chip_smoke.py`` and
``test_torch_kernels_cuda.py``.

Jacobian lanes carry K3's test patterns (identities planted, all
identities, one point repeated: the doubling branch, P and -P alternating,
one point at the top or at step 0 only, every other step the identity, all
random). Mixed (affine) lanes repeat one point, alternate P and -P, repeat
a step, or are random; JAX gets them as Jacobian rows with Z = 1, which are
the same points. k = 5 is ragged (T = 5 segments of 1), k = 64 runs
segments of 2.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from tpu_zkpool.msm import grid as jg

from test_torch_k3_wsum import _lane_points
from test_torch_msm_grid import _add, _affine, _g_points, _jacobian, _neg, \
    _rand_z
from tpu_zkpool_torch.msm import grid as tg
from tpu_zkpool_torch.msm import kernels as tk

torch.set_num_threads(1)

KS = (1, 5, 32, 64)
JLANES, MLANES = 8, 4          # Jacobian and mixed lanes per k
K_MAX = max(KS)


def _mixed_points(ncomp, k, seed):
    """Affine lanes[m][j] (never the identity) for the mixed patterns."""
    base = _g_points(ncomp, k * MLANES, seed)
    lanes = [base[m * k:(m + 1) * k] for m in range(MLANES)]
    lanes[0] = [lanes[0][0]] * k
    lanes[1] = [lanes[1][0] if j % 2 == 0 else _neg(ncomp, lanes[1][0])
                for j in range(k)]
    lanes[2] = [lanes[2][j - 1] if j % 3 == 1 else p
                for j, p in enumerate(lanes[2])]
    return lanes


def _tiles(ncomp, lanes, zs):
    """lanes[m][j] -> (k, len(lanes), 3, ncomp, 16) Jacobian rows."""
    k = len(lanes[0])
    flat = [lanes[m][j] for j in range(k) for m in range(len(lanes))]
    return _jacobian(ncomp, flat, zs).reshape(k, len(lanes), 3, ncomp, 16)


@functools.lru_cache(maxsize=None)
def _cases(ncomp):
    """{k: (Jacobian tiles with random Z, their lanes, mixed affine tiles,
    their lanes)}."""
    rng = random.Random(90 + ncomp)
    one = 1 if ncomp == 1 else (1, 0)
    out = {}
    for k in KS:
        jl = _lane_points(ncomp, k, 100 + 10 * ncomp + k)
        jt = _tiles(ncomp, jl, [_rand_z(ncomp, rng) for _ in range(k * JLANES)])
        ml = _mixed_points(ncomp, k, 200 + 10 * ncomp + k)
        mt = _tiles(ncomp, ml, [one] * (k * MLANES))[:, :, :2].contiguous()
        out[k] = (jt, jl, mt, ml)
    return out


@functools.lru_cache(maxsize=None)
def _jax_prefix(ncomp):
    """XlaBackend(ncomp).prefix over every k's lanes in one call (one
    compile): Jacobian lanes, then the mixed lanes with Z = 1, each padded
    with identity steps above its k (a prefix never reads later steps).
    -> {k: (Jacobian rows (k, JLANES, ...), mixed rows (k, MLANES, ...))}."""
    lanes = JLANES + MLANES
    rows = np.zeros((len(KS) * lanes, K_MAX, 3, ncomp, 16), np.uint32)
    one = tg._field(ncomp).one(torch.zeros((16, ncomp, 1), dtype=torch.int64))
    for i, k in enumerate(KS):
        jt, _, mt, _ = _cases(ncomp)[k]
        mj = torch.cat([mt, one[:, :, 0].T.expand(k, MLANES, ncomp, 16)
                        [:, :, None]], 2)
        blk = torch.cat([jt, mj], 1).transpose(0, 1).numpy()
        rows[i * lanes:(i + 1) * lanes, :k] = blk
    be = jg.XlaBackend(ncomp)
    be.lanes = len(KS) * lanes     # one JAX lane per test lane
    out = jax.jit(lambda r: be.prefix(r, K_MAX, mixed=False))(
        rows.reshape((-1,) + rows.shape[2:]))
    out = np.asarray(out).astype(np.int64).reshape(rows.shape)
    res = {}
    for i, k in enumerate(KS):
        blk = torch.as_tensor(out[i * lanes:(i + 1) * lanes, :k])
        res[k] = (blk[:JLANES].transpose(0, 1), blk[JLANES:].transpose(0, 1))
    return res


def _oracle(ncomp, lane):
    """Inclusive prefix sums of one lane, affine ints."""
    acc, out = None, []
    for p in lane:
        acc = _add(ncomp, acc, p)
        out.append(acc)
    return out


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("k", KS)
def test_prefix_plain_matches_jax_and_oracle(ncomp, k):
    jt, jl, mt, ml = _cases(ncomp)[k]
    jj, jm = _jax_prefix(ncomp)[k]
    for tiles, lanes, mixed, want_jax in ((jt, jl, False, jj),
                                          (mt, ml, True, jm)):
        got = tg.prefix_plain(tiles, mixed, True)
        assert got.shape == (k, len(lanes), 3, ncomp, 16)
        for m, lane in enumerate(lanes):
            want = _oracle(ncomp, lane)
            port = [_affine(ncomp, got[j, m]) for j in range(k)]
            jax_ = [_affine(ncomp, want_jax[j, m]) for j in range(k)]
            assert port == want == jax_, (k, m, mixed)


def test_prefix_schedule():
    # the split of K3: T = min(k, 32) segments of s = 2^log2s >= k / T
    assert [tg.prefix_schedule(k) for k in (1, 5, 32, 33, 64, 100)] == [
        (1, 0), (5, 0), (32, 0), (32, 1), (32, 1), (32, 2)]
    for k in range(1, 200):
        assert tg.prefix_schedule(k) == tg.wsum_schedule(k)


def test_prefix_wrapper_launches_the_schedule(monkeypatch):
    # the wrapper hands the kernel prefix_schedule(k): watch its launch on
    # a meta tensor (no values, no card)
    seen = []
    monkeypatch.setattr(tk.cuda_build, "check_tensors", lambda *a, **k: None)
    monkeypatch.setattr(tk, "_load", lambda: type("L", (), {
        "msm_prefix": None})())
    monkeypatch.setattr(tk.cuda_build, "launch",
                        lambda counts, name, dev, fn, *args: seen.append(
                            (name,) + args[2:]))
    for k, lanes, mixed in ((64, 20, False), (5, 3, True), (32, 640, False)):
        C = 2 if mixed else 3
        tiles = torch.empty((k, lanes, C, 2, 16), dtype=torch.int64,
                            device="meta")
        out = tk.prefix(tiles, mixed, True)
        assert out.shape == (k, lanes, 3, 2, 16)
        assert seen[-1] == ("prefix", k, lanes, 2, int(mixed), 1) \
            + tg.prefix_schedule(k)
