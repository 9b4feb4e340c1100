"""K6's twin, ``horner_plain``, against the JAX package's
``XlaBackend.horner``, limb for limb (tolerance zero), and a pure-int
oracle in affine form.

The redesigned K6 keeps Horner's association (from the top window down, c
doublings, then one complete add), so twin, kernel and JAX agree on every
limb; the kernel skips the top window's doublings of the identity, which
change no limb. The kernel itself is held to the twin on the card by
``chip_smoke.py`` and ``test_torch_kernels_cuda.py``.

Planted window sums: all identities; the top two windows identities with
nonzero X and Y (Z = 0); S_(W-2) = 2^c S_(W-1), so the add after the top
window's doublings takes the doubling branch, and S_(W-4) the negation of
the sum it meets (that add cancels to O); every S_w equal; random points.
W = 20, c = 13 (the prover's shape) over Fp; W = 5 over Fp2.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from tpu_zkpool import native_bridge as jnb
from tpu_zkpool.msm import grid as jg

from test_torch_msm_grid import _add, _affine, _g_points, _jacobian, _mul, \
    _rand_z
from tpu_zkpool_torch.fields.bn254 import FP_MOD, FR_MOD
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.msm import grid as tg

torch.set_num_threads(1)

C = 13
VARIANTS = ("identity", "top-identity", "doubling", "equal", "random")
WS = {1: 20, 2: 5}


@functools.lru_cache(maxsize=None)
def _cases(ncomp):
    """{variant: (S (W, 3, ncomp, 16), affine points or None)}."""
    W = WS[ncomp]
    rng = random.Random(30 + ncomp)
    ks = [rng.randrange(1, FR_MOD) for _ in range(W)]
    ks[W - 2] = ks[W - 1] << C                 # the scalars of the sums met
    ks[W - 4] = -(((ks[W - 1] << (2 * C + 1)) + ks[W - 3]) << C)
    mul = jnb.g1_gen_mul_batch if ncomp == 1 else jnb.g2_gen_mul_batch
    planted = mul([k % FR_MOD for k in ks])
    rand = _g_points(ncomp, W, 40 + ncomp)
    zs = [_rand_z(ncomp, rng) for _ in range(W)]
    pts = {"identity": [None] * W, "top-identity": rand[:W - 2] + [None] * 2,
           "doubling": planted, "equal": [rand[0]] * W, "random": rand}
    out = {v: (_jacobian(ncomp, p, zs), p) for v, p in pts.items()}
    top = out["top-identity"][0]
    top[W - 2:, :2] = torch.as_tensor(FP.to_mont(
        [[[rng.randrange(1, FP_MOD) for _ in range(ncomp)] for _ in range(2)]
         for _ in range(2)]))
    return out


@functools.lru_cache(maxsize=None)
def _jax_horner(ncomp):
    """XlaBackend(ncomp).horner, jitted once per field (its compile, ~10 s
    over Fp and ~45 s over Fp2, is most of this file's time)."""
    be = jg.XlaBackend(ncomp)
    return jax.jit(lambda s: be.horner(s, C))


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("variant", VARIANTS)
def test_horner_plain_matches_jax_and_oracle(ncomp, variant):
    S, pts = _cases(ncomp)[variant]
    got = tg.horner_plain(S, C)
    assert got.shape == (3, ncomp, 16)
    jax_out = _jax_horner(ncomp)(S.numpy().astype(np.uint32))
    assert torch.equal(got, torch.as_tensor(np.asarray(jax_out)
                                            .astype(np.int64)))
    want = None
    for w, p in enumerate(pts):
        if p is not None:
            want = _add(ncomp, want, _mul(ncomp, 1 << (C * w), p))
    assert _affine(ncomp, got) == want


@pytest.mark.parametrize("ncomp", [1, 2])
def test_horner_plain_batched_rows_equal_single_calls(ncomp):
    S = torch.stack([_cases(ncomp)[v][0] for v in VARIANTS])
    got = tg.horner_plain(S, C)
    assert got.shape == (len(VARIANTS), 3, ncomp, 16)
    for i, v in enumerate(VARIANTS):
        assert torch.equal(got[i], tg.horner_plain(_cases(ncomp)[v][0], C))
