"""Port parity: the Fp2 / Fp12 tower of ``tpu_zkpool_torch.curve.tower``
against ``tpu_zkpool.curve.tower`` on the same seeded inputs, limb for
limb (exact).

The Fp2 ops are held to the JAX functions, jitted once together (~4 s).
The JAX Fp12 product and sparse line product compile for ~20 s each and
run eagerly for ~25 s each on a CPU, so the Fp12 ops are held to the
refimpl values in the JAX package's own Montgomery encoding
(``tpu_zkpool.fields.fctx.FP.to_mont``), the values ``tests/test_tower.py``
holds the JAX ``f12_mul`` and ``f12_mul_sparse_line`` to.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.curve import tower as jt
from tpu_zkpool.fields.fctx import FP as JFP
from tpu_zkpool.refimpl import pairing_ref as pr

from tpu_zkpool_torch.curve import tower as tw

torch.set_num_threads(1)

P = pr.P


def _f2_vals(rng, n):
    # 0, 1, p - 1 and the pure-imaginary u among the values
    fixed = [(0, 0), (1, 0), (P - 1, P - 1), (0, 1)]
    return fixed[:n] + [(rng.randrange(P), rng.randrange(P))
                        for _ in range(n - len(fixed[:n]))]


def _jax_f2(vals):
    return tuple(jnp.asarray(JFP.to_mont(np.asarray([v[c] for v in vals],
                                                    dtype=object)))
                 for c in range(2))


def _port_f2(vals):
    return torch.as_tensor(np.stack([JFP.to_mont(np.asarray(
        [v[c] for v in vals], dtype=object)) for c in range(2)], 1)
        .astype(np.int64))


def _same_f2(jax_pair, port):
    want = np.stack([np.asarray(x) for x in jax_pair], 1).astype(np.int64)
    assert (port.numpy() == want).all()


def _jax_f12_limbs(vals):
    """refimpl Fp12 values in the JAX package's Montgomery limbs, [n, 12,
    16] in the JAX order (coefficient i, component c at row 2 i + c)."""
    flat = [[x for c in v for x in c] for v in vals]
    return JFP.to_mont(np.asarray(flat, dtype=object)).astype(np.int64)


def _f12_vals(rng, n):
    return [tuple((rng.randrange(P), rng.randrange(P)) for _ in range(6))
            for _ in range(n)]


def test_f2_ops_equal_jax():
    rng = random.Random(21)
    a, b = _f2_vals(rng, 6), _f2_vals(random.Random(22), 6)[::-1]
    ja, jb = _jax_f2(a), _jax_f2(b)

    @jax.jit
    def ops(x, y):
        return (jt.f2_add(x, y), jt.f2_sub(x, y), jt.f2_neg(x),
                jt.f2_conj(x), jt.f2_mul(x, y), jt.f2_sqr(x),
                jt.f2_mul_by_xi(x), jt.f2_inv(x), jt.f2_scalar_small(x, 3))

    want = ops(ja, jb)
    ta, tb = _port_f2(a), _port_f2(b)
    got = (tw.f2_add(ta, tb), tw.f2_sub(ta, tb), tw.f2_neg(ta),
           tw.f2_conj(ta), tw.f2_mul(ta, tb), tw.f2_sqr(ta),
           tw.f2_mul_by_xi(ta), tw.f2_inv(ta), tw.f2_scalar_small(ta, 3))
    for w, g in zip(want, got):
        _same_f2(w, g)
    assert tw.f2_is_zero(ta).tolist() == [True] + [False] * 5
    _same_f2(jt.f2_one((2,)), tw.f2_one((2,), device="cpu"))
    _same_f2(jt.f2_zero((2,)), tw.f2_zero((2,), device="cpu"))


@pytest.mark.parametrize("B", [1, 3])
def test_f12_mul_and_sqr(B):
    rng = random.Random(30 + B)
    a, b = _f12_vals(rng, B), _f12_vals(rng, B)
    ta, tb = (torch.as_tensor(_jax_f12_limbs(v)) for v in (a, b))
    got = tw.f12_mul(ta, tb)
    assert (got.numpy() == _jax_f12_limbs(
        [pr.f12_mul(x, y) for x, y in zip(a, b)])).all()
    assert (tw.f12_sqr(ta).numpy() == _jax_f12_limbs(
        [pr.f12_mul(x, x) for x in a])).all()
    # a broadcast operand: one element against the batch
    assert (tw.f12_mul(ta[:1], tb).numpy() == _jax_f12_limbs(
        [pr.f12_mul(a[0], y) for y in b])).all()


def test_f12_sparse_line_product():
    rng = random.Random(41)
    f = _f12_vals(rng, 2)
    ls = [_f2_vals(rng, 6)[4:] for _ in range(3)]         # two each
    tf = torch.as_tensor(_jax_f12_limbs(f))
    got = tw.f12_mul_sparse_line(tf, *(_port_f2(x) for x in ls))
    want = [pr.f12_mul(f[i], (ls[0][i], ls[1][i], (0, 0), ls[2][i], (0, 0),
                              (0, 0))) for i in range(2)]
    assert (got.numpy() == _jax_f12_limbs(want)).all()
    # the Miller loop's shape: l0 in Fp (c1 = 0), one line for the batch
    l0 = (ls[0][0][0], 0)
    got = tw.f12_mul_sparse_line(tf, *(_port_f2([x])[0]
                                       for x in (l0, ls[1][0], ls[2][0])))
    want = [pr.f12_mul(x, (l0, ls[1][0], (0, 0), ls[2][0], (0, 0), (0, 0)))
            for x in f]
    assert (got.numpy() == _jax_f12_limbs(want)).all()


def test_f12_one_conj_eq_one_and_ints():
    rng = random.Random(51)
    a = _f12_vals(rng, 3)
    ta = tw.f12_from_ints(a, device="cpu")
    assert (ta.numpy() == _jax_f12_limbs(a)).all()
    assert tw.f12_to_ints(ta) == a
    assert (tw.f12_conj(ta).numpy() == _jax_f12_limbs(
        [pr.f12_conj(x) for x in a])).all()
    one = tw.f12_one((2,), device="cpu")
    assert (one.numpy() == _jax_f12_limbs([pr.F12_ONE] * 2)).all()
    jone = jt.f12_one((2,))
    assert (one.numpy() == np.stack([np.asarray(c) for pair in jone
                                     for c in pair], 1)).all()
    both = torch.cat([ta, one])
    assert tw.f12_eq_one(both).tolist() == [False] * 3 + [True] * 2
    jb = tuple((jnp.asarray(both[:, 2 * i].numpy().astype(np.uint32)),
                jnp.asarray(both[:, 2 * i + 1].numpy().astype(np.uint32)))
               for i in range(6))
    assert np.asarray(jt.f12_eq_one(jb)).tolist() == \
        tw.f12_eq_one(both).tolist()
