"""K3's twin, ``wsum_plain``, against the JAX package and a pure-int oracle.

The twin follows the kernel's block-parallel schedule (``wsum_schedule``:
T segments a lane, a suffix scan and a tree over them), so its Jacobian
limbs differ from JAX's serial scan (``XlaBackend.wsum``, one add after
another from the top step down); both are compared in affine form, exactly
(tolerance zero). The kernel itself is held to the twin limb for limb on the
card by ``chip_smoke.py`` and ``test_torch_kernels_cuda.py``.

Every lane carries a pattern: random points with identities planted, all
identities, one point repeated (equal partial sums: the doubling branch),
B_(2i+1) = -B_(2i) (sums that cancel), one point at the top step only or
at step 0 only, every other step the identity, all random. L = 5 is ragged
(T = 5 segments), L = 128 pads nothing (32 segments of 4).
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.msm import grid as jg

from test_torch_msm_grid import _add, _affine, _g_points, _jacobian, _neg, \
    _rand_z
from tpu_zkpool_torch.msm import grid as tg

torch.set_num_threads(1)

LS = (1, 5, 32, 128)
LANES = 8              # one lane of each pattern
L_MAX = max(LS)


def _lane_points(ncomp, L, seed):
    """Affine points (None = identity), lanes[m][l] for each pattern."""
    base = _g_points(ncomp, L * LANES, seed)
    lanes = [base[m * L:(m + 1) * L] for m in range(LANES)]
    for m, g in enumerate(lanes):
        if m == 0:
            lanes[m] = [None if l % 3 == 1 else p for l, p in enumerate(g)]
        elif m == 1:
            lanes[m] = [None] * L
        elif m == 2:
            lanes[m] = [g[0]] * L
        elif m == 3:
            lanes[m] = [p if l % 2 == 0 else _neg(ncomp, g[l - 1])
                        for l, p in enumerate(g)]
        elif m == 4:
            lanes[m] = [None] * (L - 1) + [g[0]]
        elif m == 5:
            lanes[m] = [g[0]] + [None] * (L - 1)
        elif m == 6:
            lanes[m] = [p if l % 2 else None for l, p in enumerate(g)]
    return lanes


@functools.lru_cache(maxsize=None)
def _cases(ncomp):
    """{L: (steps (L, LANES, 3, ncomp, 16) with random Z, affine lanes)}."""
    rng = random.Random(50 + ncomp)
    out = {}
    for L in LS:
        lanes = _lane_points(ncomp, L, 60 + 10 * ncomp + L)
        flat = [lanes[m][l] for l in range(L) for m in range(LANES)]
        rows = _jacobian(ncomp, flat, [_rand_z(ncomp, rng) for _ in flat])
        out[L] = (rows.reshape(L, LANES, 3, ncomp, 16), lanes)
    return out


@functools.lru_cache(maxsize=None)
def _jax_wsum(ncomp):
    """XlaBackend(ncomp).wsum over every L's lanes in one call (one
    compile): each lane padded with identity steps above its L, which its
    top-down scan passes through unchanged. -> {L: (acc, tot) rows}."""
    B = np.zeros((len(LS) * LANES, L_MAX, 3, ncomp, 16), np.uint32)
    for i, L in enumerate(LS):
        steps = _cases(ncomp)[L][0]
        B[i * LANES:(i + 1) * LANES, :L] = steps.transpose(0, 1).numpy()
    acc, tot = jg.XlaBackend(ncomp).wsum(jnp.asarray(B))
    acc, tot = (np.asarray(v).astype(np.int64) for v in (acc, tot))
    return {L: (acc[i * LANES:(i + 1) * LANES], tot[i * LANES:(i + 1) * LANES])
            for i, L in enumerate(LS)}


def _oracle(ncomp, lane):
    """(sum_l B_l, sum_l (l + 1) B_l) in affine ints: the running sum from
    the top step down, and the sum of those running sums."""
    acc = tot = None
    for p in reversed(lane):
        acc = _add(ncomp, acc, p)
        tot = _add(ncomp, tot, acc)
    return acc, tot


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("L", LS)
def test_wsum_plain_matches_jax_and_oracle(ncomp, L):
    steps, lanes = _cases(ncomp)[L]
    got = tg.wsum_plain(steps)
    assert got.shape == (2, LANES, 3, ncomp, 16)
    jacc, jtot = _jax_wsum(ncomp)[L]
    for m in range(LANES):
        want = _oracle(ncomp, lanes[m])
        port = (_affine(ncomp, got[0, m]), _affine(ncomp, got[1, m]))
        jax_ = (_affine(ncomp, torch.as_tensor(jacc[m])),
                _affine(ncomp, torch.as_tensor(jtot[m])))
        assert port == want == jax_, (L, m)


def test_wsum_schedule():
    # T = min(L, 32) segments of s = 2^log2s >= ceil(L / T) steps
    assert [tg.wsum_schedule(L) for L in (1, 5, 32, 33, 40, 64, 100, 128)] \
        == [(1, 0), (5, 0), (32, 0), (32, 1), (32, 1), (32, 1), (32, 2),
            (32, 2)]
    for L in range(1, 300):
        T, log2s = tg.wsum_schedule(L)
        assert 1 <= T <= 32 and T * (1 << log2s) >= L
        assert T * (1 << log2s) < 2 * L or T == L
