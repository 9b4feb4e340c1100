"""Port parity: the mod-q field and the RLWE NTT of ``tpu_zkpool_torch``
against ``tpu_zkpool.fields.rlweq`` and ``tpu_zkpool.rlwe.ntt``.

The same seeded numpy uint32 values go through both; the port holds them in
int32. Exact integers throughout: the tolerance is zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.fields import rlweq as jq
from tpu_zkpool.rlwe import ntt as jn

from tpu_zkpool_torch.fields import rlweq as tq
from tpu_zkpool_torch.rlwe import ntt as tn

Q = jq.Q
EDGE = [0, 1, 2, Q - 2, Q - 1]


def _pairs(n=2000, seed=3):
    """Seeded uint32 operands < q with every pair of edge values."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, Q, n, dtype=np.uint32)
    b = rng.integers(0, Q, n, dtype=np.uint32)
    e = np.array(EDGE, dtype=np.uint32)
    a[:e.size ** 2] = np.repeat(e, e.size)
    b[:e.size ** 2] = np.tile(e, e.size)
    return a, b


def test_constants_match_jax():
    assert (tq.Q, tq.W, tq.R, tq.R_MOD_Q, tq.R2_MOD_Q, tq.R_INV,
            tq.QINV_NEG) == (jq.Q, jq.W, jq.R, jq.R_MOD_Q, jq.R2_MOD_Q,
                             jq.R_INV, jq.QINV_NEG)
    assert Q * tq.QINV_NEG_R % tq.R == tq.R - 1


@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_ops_match_jax(op):
    a, b = _pairs()
    want = np.asarray(getattr(jq, op)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tq, op)(tq.from_numpy_u32(a, device="cpu"),
                          tq.from_numpy_u32(b, device="cpu"))
    assert got.dtype == torch.int32
    assert (tq.to_numpy_u32(got) == want).all()


@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont", "pow_const"])
def test_unary_ops_match_jax(op):
    a, _ = _pairs(seed=4)
    args = (12345,) if op == "pow_const" else ()
    want = np.asarray(getattr(jq, op)(jnp.asarray(a), *args))
    got = getattr(tq, op)(tq.from_numpy_u32(a, device="cpu"), *args)
    assert (tq.to_numpy_u32(got) == want).all()


@pytest.mark.parametrize("n", [64, 1024])
def test_tables_match_jax(n):
    assert tn._find_generator() == jn._find_generator()
    jt, tt = jn._tables(n), tn._tables(n)
    for j, t in zip(jt[:2], tt[:2]):
        assert t.dtype == np.uint32 and (t == j).all()
    for js, ts in zip(jt[2:], tt[2:]):
        assert len(js) == len(ts) == n.bit_length() - 1
        assert all((x == y).all() for x, y in zip(js, ts))


@functools.lru_cache(maxsize=None)
def _jax_fns():
    return (jax.jit(jn.forward), jax.jit(jn.inverse),
            jax.jit(jn.negacyclic_mul))


@pytest.mark.parametrize("n", [64, 1024])
def test_forward_inverse_mul_match_jax(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, Q, (4, n), dtype=np.uint32)
    y = rng.integers(0, Q, (4, n), dtype=np.uint32)
    x[0, :len(EDGE)] = EDGE
    fwd, inv, mul = _jax_fns()
    tx = tq.from_numpy_u32(x, device="cpu")
    ty = tq.from_numpy_u32(y, device="cpu")
    f = tn.forward(tx)
    assert (tq.to_numpy_u32(f) == np.asarray(fwd(jnp.asarray(x)))).all()
    assert (tq.to_numpy_u32(tn.inverse(tx))
            == np.asarray(inv(jnp.asarray(x)))).all()
    assert torch.equal(tn.inverse(f), tx)
    assert (tq.to_numpy_u32(tn.negacyclic_mul(tx, ty))
            == np.asarray(mul(jnp.asarray(x), jnp.asarray(y)))).all()
