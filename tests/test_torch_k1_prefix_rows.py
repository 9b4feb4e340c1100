"""K1's twin, ``prefix_rows_plain``, against the JAX package's
``XlaBackend.prefix_signed``, limb for limb (tolerance zero).

K1 now runs every window of a slice at once and gathers its own rows: it
takes the affine source rows and a step-major payload (W, k, lanes) of
index | neg << 31, and returns the prefix in sorted order (W, k * lanes, 3,
ncomp, 16). Each lane still scans its k steps serially in the same order,
so each window's slice equals JAX's ``prefix_signed`` on that window's
gathered rows and signs. ``XlaBackend`` fixes 1,024 lanes. The kernel itself
is held to the twin on the card by ``chip_smoke.py`` and
``test_torch_kernels_cuda.py``.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from tpu_zkpool.msm import grid as jg

from test_torch_msm_grid import _g_points, _jacobian, _neg
from tpu_zkpool_torch.msm import grid as tg
from tpu_zkpool_torch.msm import kernels as tk

torch.set_num_threads(1)

W, K, LANES = 3, 2, 1024
N = K * LANES


@functools.lru_cache(maxsize=None)
def _inputs(ncomp):
    """xy (N, 2, ncomp, 16) and payload (W, K, LANES). Rows 0 and 1 hold the
    generator (the pipeline's stand-in for identity inputs), row 3 is -row
    2; window 0 reads row j * LANES + l at step j of lane l, windows 1 and 2
    a seeded permutation. In every window step 1 repeats step 0's row with
    its sign in lanes 0 mod 4 (P = Q) and with the other sign in lanes 1
    mod 4 (P = -Q); lane 2 adds row 2 then row 3 (P = -Q by the points),
    lane 3 row 0 then row 1 (P = Q by the points). Signs are random."""
    rng = random.Random(70 + ncomp)
    pts = _g_points(ncomp, N, 80 + ncomp)
    pts[1] = pts[0]
    pts[3] = _neg(ncomp, pts[2])
    one = 1 if ncomp == 1 else (1, 0)
    xy = _jacobian(ncomp, pts, [one] * N)[:, :2].contiguous()
    xy[0] = xy[1] = tg._safe_point(ncomp, "cpu")
    payload = []
    for w in range(W):
        idx = list(range(N))
        if w:
            rng.shuffle(idx)
        neg = [rng.randrange(2) for _ in range(N)]
        for l in range(0, LANES, 4):
            idx[LANES + l], neg[LANES + l] = idx[l], neg[l]
            idx[LANES + l + 1], neg[LANES + l + 1] = idx[l + 1], 1 - neg[l + 1]
        for l, (a, b) in ((2, (2, 3)), (3, (0, 1))):
            idx[l], idx[LANES + l] = a, b
            neg[l] = neg[LANES + l] = w % 2
        payload.append([i | (s << 31) for i, s in zip(idx, neg)])
    payload = torch.tensor(payload, dtype=torch.int64).reshape(W, K, LANES)
    return xy, payload


@functools.lru_cache(maxsize=None)
def _port(ncomp):
    xy, payload = _inputs(ncomp)
    return tg.prefix_rows_plain(xy, payload, complete=True)


@functools.lru_cache(maxsize=None)
def _jax_prefix_signed(ncomp):
    be = jg.XlaBackend(ncomp)
    assert be.lanes == LANES
    return jax.jit(lambda rows, signs: be.prefix_signed(rows, signs, K))


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("w", range(W))
def test_prefix_rows_plain_matches_jax_prefix_signed(ncomp, w):
    xy, payload = _inputs(ncomp)
    got = _port(ncomp)
    assert got.shape == (W, N, 3, ncomp, 16)
    pv = payload[w].reshape(-1)                 # row j * LANES + l
    rows_t = xy[pv & 0x7FFFFFFF].reshape(N, -1).numpy().astype(np.uint32)
    signs_t = (pv >> 31).numpy().astype(np.uint32)
    want = np.asarray(_jax_prefix_signed(ncomp)(rows_t, signs_t))
    assert (got[w].numpy() == want.astype(np.int64)).all()


def test_prefix_rows_wrapper_checks_and_dispatch():
    xy, payload = _inputs(1)
    # a CPU tensor runs the twin; bad shapes and dtypes raise here as on
    # the card
    assert torch.equal(tk.prefix_rows(xy, payload, True), _port(1))
    with pytest.raises(ValueError, match=r"want int64 \(W, k, lanes\)"):
        tk.prefix_rows(xy, payload[0], True)
    with pytest.raises(ValueError, match=r"want int64 \(W, k, lanes\)"):
        tk.prefix_rows(xy, payload.int(), True)
    with pytest.raises(ValueError, match="point-row shape"):
        tk.prefix_rows(torch.zeros((N, 3, 1, 16), dtype=torch.int64),
                       payload, True)
