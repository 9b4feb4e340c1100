"""Port parity: the client curves (``tpu_zkpool_torch.curve.weierstrass``,
``curve.fixed_base``) against ``tpu_zkpool.curve`` and the host oracles.

``add`` and ``double`` equal JAX's jitted ``EMBEDDED.add`` / ``.double`` and
``G1.add`` limb for limb on planted identity, doubling, cancelling and
generic lanes with Jacobian (Z != 1) inputs; ``scalar_mul`` and
``FixedBaseTable.mul_ints`` equal ``refimpl.curve_ref``, ``pairing_ref`` and
the committed identity vector (the oracles of ``tests/test_curve.py``); the
fixed-base tables and the bit and digit arrays equal JAX's, and the JAX
tables carried over through ``limbs.from_jax`` give the port's products.
Inputs come from ``random.Random`` seeds; everything runs on the CPU.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch

from tpu_zkpool.curve import fixed_base as jfb
from tpu_zkpool.curve import weierstrass as jw

from tpu_zkpool_torch.curve import fixed_base as fb
from tpu_zkpool_torch.curve.weierstrass import EMBEDDED, G1, G1_UNROLLED
from tpu_zkpool_torch.fields.bn254 import G1_GX, G1_GY
from tpu_zkpool_torch.fields.limbs import from_jax
from tpu_zkpool_torch.refimpl import curve_ref
from tpu_zkpool_torch.refimpl import pairing_ref as pr

import vectors

CPU = "cpu"
CURVES = {"embedded": (EMBEDDED, jw.EMBEDDED), "g1": (G1, jw.G1)}


def _mul_ref(name, k, base=None):
    """The host oracle: curve_ref on the embedded curve, pairing_ref on
    G1; the identity as (0, 0)."""
    if name == "embedded":
        return curve_ref.scalar_mul(k, base or curve_ref.GEN) or (0, 0)
    return pr.g1_mul(k, base or (G1_GX, G1_GY)) or (0, 0)


def _neg(name, p):
    return (p[0], (-p[1]) % CURVES[name][0].F.modulus)


@functools.lru_cache(maxsize=None)
def _lanes(name, seed=11):
    """(P, Q) Jacobian batches of 8 lanes on the CPU: generic, P = inf,
    Q = inf, both inf, P = Q (different Z), P = -Q, generic, P = Q (same
    limbs). P's lanes are doublings (Z != 1), Q's affine (Z = 1)."""
    C = CURVES[name][0]
    rng = random.Random(seed)
    ks = [rng.randrange(1, 1 << 60) for _ in range(8)]
    half = [_mul_ref(name, k) for k in ks]               # P = 2 * half
    full = [_mul_ref(name, 2 * k) for k in ks]
    other = [_mul_ref(name, rng.randrange(1, 1 << 60)) for _ in range(8)]
    q = list(other)
    q[4] = full[4]                                       # doubling
    q[5] = _neg(name, full[5])                           # cancelling
    P = C.double(C.from_affine_ints(*zip(*half), device=CPU))
    Q = C.from_affine_ints(*zip(*q), device=CPU)
    P, Q = [list(map(torch.clone, t)) for t in (P, Q)]
    for i in range(3):
        P[i][7] = Q[i][7] = P[i][0]                      # same limbs
        for lane, T in ((1, P), (2, Q), (3, P), (3, Q)):
            T[i][lane] = 0                               # identities
    return tuple(P), tuple(Q)


def _u32(T):
    return tuple(np.asarray(t.numpy(), dtype=np.uint32) for t in T)


def _limbs_equal(got, want):
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w).astype(np.int64)).all()


@pytest.mark.parametrize("name", ["embedded", "g1"])
def test_add_equals_jax_limb_for_limb(name):
    C, J = CURVES[name]
    P, Q = _lanes(name)
    got = C.add(P, Q)
    _limbs_equal(got, jax.jit(J.add)(_u32(P), _u32(Q)))
    xs, ys = C.to_affine_ints(got)
    assert (int(xs[1]), int(ys[1])) == tuple(int(v[1]) for v in
                                             C.to_affine_ints(Q))
    assert (int(xs[5]), int(ys[5])) == (0, 0)            # P + (-P)
    assert bool(C.F.is_zero(got[2])[5]) and bool(C.F.is_zero(got[2])[3])


def test_double_equals_jax_limb_for_limb():
    C, J = CURVES["embedded"]
    P, Q = _lanes("embedded")
    for T in (P, Q):
        _limbs_equal(C.double(T), jax.jit(J.double)(_u32(T)))


def test_affine_round_trip_and_unrolled_alias():
    assert G1_UNROLLED is G1
    for name, (C, J) in CURVES.items():
        pts = [_mul_ref(name, k) for k in (3, 5, 7)]
        T = C.from_affine_ints(*zip(*pts), device=CPU)
        _limbs_equal(T, J.from_affine_ints(*zip(*pts)))
        xs, ys = C.to_affine_ints(C.double(T))
        assert [(int(x), int(y)) for x, y in zip(xs, ys)] == [
            _mul_ref(name, 2 * k) for k in (3, 5, 7)]


def test_embedded_scalar_mul_batch():
    ks = [12345, vectors.SECRET_KEY, 1, 0, (1 << 128) - 1]
    C = EMBEDDED
    bits = C.bits_from_ints(ks, 128)
    assert (bits == jw.CurveOps.bits_from_ints(ks, 128).astype(np.int64)).all()
    G = C.from_affine_ints([C.gen[0]] * len(ks), [C.gen[1]] * len(ks),
                           device=CPU)
    xs, ys = C.to_affine_ints(C.scalar_mul(bits, G))
    for i, k in enumerate(ks):
        assert (int(xs[i]), int(ys[i])) == _mul_ref("embedded", k), k
    assert (int(xs[1]), int(ys[1])) == (vectors.OWNER_X, vectors.OWNER_Y)


def test_g1_scalar_mul_matches_pairing_ref():
    rng = random.Random(3)
    ks = [rng.randrange(1 << 64) for _ in range(3)] + [0, (1 << 64) - 1]
    G = G1.from_affine_ints([G1_GX] * len(ks), [G1_GY] * len(ks), device=CPU)
    xs, ys = G1.to_affine_ints(G1.scalar_mul(G1.bits_from_ints(ks, 64), G))
    assert [(int(x), int(y)) for x, y in zip(xs, ys)] == [
        _mul_ref("g1", k) for k in ks]


@functools.lru_cache(maxsize=None)
def _tables(name, c, nbits):
    C, J = CURVES[name]
    return (fb.FixedBaseTable(C, c=c, nbits=nbits, device=CPU),
            jfb.FixedBaseTable(J, c=c, nbits=nbits))


@pytest.mark.parametrize("name,c,nbits", [("embedded", 4, 256),
                                          ("embedded", 8, 256),
                                          ("g1", 4, 64)])
def test_fixed_base_tables_equal_jax(name, c, nbits):
    """The window tables limb for limb, and the digits; the JAX tables
    carried over through ``from_jax`` give the port's products."""
    tbl, jtbl = _tables(name, c, nbits)
    assert tbl.n_windows == jtbl.n_windows
    for a in ("tx", "ty", "tz"):
        assert torch.equal(getattr(tbl, a),
                           from_jax(np.asarray(getattr(jtbl, a)), device=CPU))
    rng = random.Random(c)
    ks = [rng.randrange(1 << nbits) for _ in range(3)] + [0, 1]
    assert (tbl.digits(ks) == jtbl.digits(ks).astype(np.int64)).all()
    carried = fb.FixedBaseTable.__new__(fb.FixedBaseTable)
    carried.__dict__.update(tbl.__dict__, **{
        a: from_jax(np.asarray(getattr(jtbl, a)), device=CPU)
        for a in ("tx", "ty", "tz")})
    got = tbl.mul_ints(ks)
    for g, w in zip(got, carried.mul_ints(ks)):
        assert torch.equal(g, w)
    xs, ys = tbl.curve.to_affine_ints(got)
    assert [(int(x), int(y)) for x, y in zip(xs, ys)] == [
        _mul_ref(name, k) for k in ks]


def test_fixed_base_keygen_vector():
    """The identity-keygen table (c = 8) on the committed vector, the
    generator, and the edge scalars."""
    tbl = fb.embedded_generator_table(c=8, device=CPU)
    assert fb.embedded_generator_table(8, device="cpu") is tbl
    order = EMBEDDED.order
    ks = [vectors.SECRET_KEY, 1, 2, 12345, (1 << 128) - 1, 0, order - 1]
    xs, ys = EMBEDDED.to_affine_ints(tbl.mul_ints(ks))
    got = [(int(x), int(y)) for x, y in zip(xs, ys)]
    assert got[0] == (vectors.OWNER_X, vectors.OWNER_Y)
    assert got[1] == EMBEDDED.gen
    assert got == [_mul_ref("embedded", k) for k in ks]
    assert got[6] == _neg("embedded", EMBEDDED.gen)


def test_curve_entry_points_ask_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: EMBEDDED.identity((2,)),
                 lambda: EMBEDDED.from_affine_ints([1], [2]),
                 lambda: fb.embedded_generator_table(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
