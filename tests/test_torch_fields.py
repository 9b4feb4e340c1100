"""Port parity: ``tpu_zkpool_torch.fields`` against ``tpu_zkpool.fields``.

The same seeded values (256 random ones plus 0, 1 and p - 1) go through the
JAX ``FieldCtx`` and the port's; the port's int64 limbs must equal the JAX
uint32 limbs exactly.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.fields import fctx as jf
from tpu_zkpool.fields import limbs as jl

from tpu_zkpool_torch.fields import fctx as tf
from tpu_zkpool_torch.fields import limbs as tl

torch.set_num_threads(1)

FIELDS = ["FR", "FP"]


def _values(p, seed):
    rng = random.Random(seed)
    return [rng.randrange(p) for _ in range(256)] + [0, 1, p - 1]


def _pair(name, seed):
    J, T = getattr(jf, name), getattr(tf, name)
    xs = _values(T.modulus, seed)
    ys = _values(T.modulus, seed + 1)
    a, b = T.to_mont(xs), T.to_mont(ys)
    assert (a == J.to_mont(np.asarray(xs, dtype=object)).astype(np.int64)).all()
    return J, T, a, b


def _same(jax_out, port_out):
    assert (np.asarray(jax_out).astype(np.int64) == port_out.numpy()).all()


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul", "mont_sqr", "neg"])
def test_arith_matches_jax(name, op):
    J, T, a, b = _pair(name, 3)
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    if op in ("neg", "mont_sqr"):
        _same(getattr(J, op)(ja), getattr(T, op)(ta))
    else:
        _same(getattr(J, op)(ja, jb), getattr(T, op)(ta, tb))


@pytest.mark.parametrize("name", FIELDS)
def test_pow_inv_matches_jax(name):
    J, T, a, _ = _pair(name, 5)
    a = a[-8:]                         # includes 0, 1 and p - 1
    ja, ta = jnp.asarray(a.astype(np.uint32)), torch.as_tensor(a)
    _same(J.mont_pow(ja, 0x1234567), T.mont_pow(ta, 0x1234567))
    _same(J.inv(ja), T.inv(ta))
    vals = [int(v) for v in T.from_mont(T.inv(ta))]
    ref = [pow(int(x), -1, T.modulus) if x else 0
           for x in T.from_mont(ta)]
    assert vals == ref


@pytest.mark.parametrize("name", FIELDS)
def test_select_eq_is_zero_match_jax(name):
    J, T, a, b = _pair(name, 7)
    b[::3] = a[::3]
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    cond = np.arange(a.shape[0]) % 2 == 0
    _same(J.select(jnp.asarray(cond), ja, jb),
          T.select(torch.as_tensor(cond), ta, tb))
    assert (np.asarray(J.eq(ja, jb)) == T.eq(ta, tb).numpy()).all()
    assert (np.asarray(J.is_zero(ja)) == T.is_zero(ta).numpy()).all()
    assert T.is_zero(ta).sum() == 1    # the value 0


@pytest.mark.parametrize("name", FIELDS)
def test_constants_and_roundtrips(name):
    J, T = getattr(jf, name), getattr(tf, name)
    assert (T.modulus, T.n0, T.r_mod_p, T.r2_mod_p, T.r_inv) == (
        J.modulus, J.n0, J.r_mod_p, J.r2_mod_p, J.r_inv)
    assert (T.p_limbs == J.p_limbs.astype(np.int64)).all()
    _same(J.ones_mont((3,)), T.ones_mont((3,), device="cpu"))
    xs = _values(T.modulus, 9)
    limbs = tl.ints_to_limbs(xs)
    assert (limbs == jl.ints_to_limbs(xs).astype(np.int64)).all()
    assert list(tl.limbs_to_ints(torch.as_tensor(limbs))) == xs
    assert [int(v) for v in T.from_mont(torch.as_tensor(T.to_mont(xs)))] == xs
    assert tl.limbs_to_int(tl.int_to_limbs(xs[0])) == xs[0]
    packed = tl.pack_limbs16(limbs)
    assert (packed == jl.pack_limbs16(limbs.astype(np.uint32))).all()
    unpacked = tl.unpack_limbs16(torch.as_tensor(packed.astype(np.int64)))
    _same(jl.unpack_limbs16_jnp(jnp.asarray(packed)), unpacked)


# ------------------------------------------- the sync-free carry of _norm

def _ripple(cols, wrap):
    """The value of limb columns (n, B) int64, carried limb by limb with
    Python ints -> canonical limbs (n, B) (mod 2^(16 n) when ``wrap``)."""
    n = cols.shape[0]
    out = []
    for b in range(cols.shape[1]):
        v = sum(int(c) << (16 * i) for i, c in enumerate(cols[:, b]))
        assert wrap or v < 1 << (16 * n)
        v %= 1 << (16 * n)
        out.append([(v >> (16 * i)) & 0xFFFF for i in range(n)])
    return torch.tensor(out, dtype=torch.int64).T


@pytest.mark.parametrize("wrap", [False, True])
def test_norm_resolves_every_ripple(wrap):
    M = tl.MASK
    cases = [
        [M + 1] + [M] * 16,           # a ripple across all 17 limbs
        [M + 1] + [M] * 15 + [0],     # lands on 2^256 exactly
        [M] * 16 + [0],               # nothing to carry
        [0] * 17,
        [M + 1, 0, M + 1, M, M, 3] + [M] * 11,
    ]
    rng = random.Random(5 if wrap else 6)
    for _ in range(400):              # limbs in [0, 2^16], mostly 2^16 or M
        cases.append([rng.choice([M + 1, M, M, rng.randrange(M)])
                      for _ in range(17)])
    cols = torch.tensor(cases, dtype=torch.int64).T
    if not wrap:
        cols[16] = 0                  # the value fits the 17 limbs
    got = tf._norm(cols.clone(), 1, wrap=wrap)
    assert torch.equal(got, _ripple(cols, wrap))
    # columns up to 2^37 take 3 passes first
    big = torch.tensor([[rng.randrange(1 << 37) for _ in range(64)]
                        for _ in range(17)], dtype=torch.int64)
    if not wrap:
        big[15:] = 0
    assert torch.equal(tf._norm(big.clone(), 3, wrap=wrap),
                       _ripple(big, wrap))


@pytest.mark.parametrize("name", FIELDS)
def test_add_sub_landing_on_p_and_2_256(name):
    T = getattr(tf, name)
    p = T.modulus
    pairs = [(p - 1, 1), (1, p - 1), (p - 2, 1), (0, 0)]
    a = torch.as_tensor(tl.ints_to_limbs([x for x, _ in pairs]))
    b = torch.as_tensor(tl.ints_to_limbs([y for _, y in pairs]))
    # a + b = p reduces to 0; a - a = a - a + 2^256 - 2^256 lands on 2^256
    assert list(tl.limbs_to_ints(T.add(a, b))) == [0, 0, p - 1, 0]
    assert list(tl.limbs_to_ints(T.sub(a, a))) == [0] * 4
    assert list(tl.limbs_to_ints(T.sub(b, a))) == [
        (y - x) % p for x, y in pairs]


@pytest.mark.parametrize("name", FIELDS)
def test_lm_ops_never_read_the_host(name):
    # a meta tensor has no values: any host read (bool, item) raises
    T = getattr(tf, name)
    a = torch.empty((16, 8), dtype=torch.int64, device="meta")
    for op in (T.lm_add, T.lm_sub, T.lm_mul):
        out = op(a, a)
        assert out.shape == (16, 8) and out.device.type == "meta"
