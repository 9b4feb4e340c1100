"""Port parity: the Fr NTT and H(X) of ``tpu_zkpool_torch`` against
``tpu_zkpool.groth16.domain`` / ``prove_tpu`` on the same seeded inputs."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.fields.fctx import FR as JFR
from tpu_zkpool.groth16 import domain as jd
from tpu_zkpool.groth16 import prove_tpu as jpt
from tpu_zkpool.refimpl.groth16_ref import R1CS, compute_h

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.groth16 import domain as td
from tpu_zkpool_torch.groth16 import prove as tp

torch.set_num_threads(1)


def _evals(n, seed, rows=()):
    rng = random.Random(seed)
    vals = np.asarray([[rng.randrange(R) for _ in range(n)]
                       for _ in range(rows or 1)], dtype=object)
    m = FR.to_mont(vals)
    m = m if rows else m[0]
    return jnp.asarray(m.astype(np.uint32)), torch.as_tensor(m)


def _same(jax_out, port_out):
    assert (np.asarray(jax_out).astype(np.int64) == port_out.numpy()).all()


NTT_FNS = ("forward", "inverse", "interpolate_natural", "coset_forward",
           "coset_inverse")


@functools.lru_cache(maxsize=None)
def _jax_ntt(n):
    """Inputs (a leading batch axis of 2) and the JAX outputs of every NTT
    function at size n, from one jitted call (one compile per n)."""
    jx, tx = _evals(n, n, rows=2)
    outs = jax.jit(lambda x: tuple(getattr(jd, f)(x) for f in NTT_FNS))(jx)
    return tx, dict(zip(NTT_FNS, outs))


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("fn", NTT_FNS)
def test_ntt_matches_jax(n, fn):
    tx, want = _jax_ntt(n)
    _same(want[fn], getattr(td, fn)(tx))


def test_ntt_tables_match_jax():
    n = 16
    jt, tt = jd._tables(n), td._tables(n)
    for a, b in zip(jt[0] + jt[1], tt[0] + tt[1]):
        assert (np.asarray(a).astype(np.int64) == b).all()
    for i in (2, 3, 4):
        assert (np.asarray(jt[i]).astype(np.int64) == tt[i]).all()
    assert (jd.bitrev_perm(n) == td.bitrev_perm(n)).all()


def _tiny():
    r1cs = R1CS(num_vars=5, num_public=2,
                a_rows=[{2: 1}, {3: 1}, {}],
                b_rows=[{2: 1}, {2: 1}, {0: 1}],
                c_rows=[{3: 1}, {4: 1},
                        {1: 1, 4: -1 % R, 2: -1 % R, 0: -5 % R}])
    x = 3
    return r1cs, [1, x**3 + x + 5, x, x * x, x**3]


def test_compute_h_device_matches_jax():
    r1cs, w = _tiny()
    want = jpt.compute_h_device(r1cs, w, 4)
    assert want == compute_h(r1cs, w, 4)
    assert tp.compute_h_device(r1cs, w, 4, device="cpu") == want
    limbs = tp.compute_h_device(r1cs, w, 4, as_limbs=True, device="cpu")
    assert [int(v) for v in limbs.numpy().dot(1 << (16 * np.arange(16,
            dtype=object)))] == want


def _squares(m, x=3):
    """x_{i+1} = x_i^2 over m rows: vars [1, x_0, ..., x_m], x_0 public."""
    r1cs = R1CS(num_vars=m + 2, num_public=2,
                a_rows=[{1 + i: 1} for i in range(m)],
                b_rows=[{1 + i: 1} for i in range(m)],
                c_rows=[{2 + i: 1} for i in range(m)])
    w = [1, x]
    for _ in range(m):
        w.append(w[-1] * w[-1] % R)
    return r1cs, w


def test_compute_h_device_split_dispatch(monkeypatch):
    """``compute_h_device`` at a domain at the split threshold (lowered to
    the test's n = 16) takes ``_h_pipeline_split`` and gives the monolithic
    path's H and ``refimpl``'s."""
    r1cs, w = _squares(11)
    n = 16
    mono = tp.compute_h_device(r1cs, w, n, device="cpu")
    mono_limbs = tp.compute_h_device(r1cs, w, n, as_limbs=True,
                                     device="cpu")
    calls = []
    split = tp._h_pipeline_split

    def spy(*a, **k):
        calls.append(1)
        return split(*a, **k)

    monkeypatch.setattr(tp, "_h_pipeline_split", spy)
    monkeypatch.setattr(tp, "_H_SPLIT_MIN_N", n)
    got = tp.compute_h_device(r1cs, w, n, device="cpu")
    got_limbs = tp.compute_h_device(r1cs, w, n, as_limbs=True, device="cpu")
    assert len(calls) == 2
    assert got == mono == compute_h(r1cs, w, n)
    assert torch.equal(got_limbs, mono_limbs)


def test_ntt_tables_match_jax_at_larger_sizes():
    """The tables' running products and strided stages against JAX's pow
    per entry, at n = 1, 2 and 1,024."""
    for n in (1, 2, 1024):
        jt, tt = jd._tables(n), td._tables(n)
        assert len(jt[0]) == len(tt[0]) and len(jt[1]) == len(tt[1])
        for a, b in zip(jt[0] + jt[1], tt[0] + tt[1]):
            assert (np.asarray(a).astype(np.int64) == b).all()
        for i in (2, 3, 4):
            assert (np.asarray(jt[i]).astype(np.int64) == tt[i]).all()
        assert (jd.bitrev_perm(n) == td.bitrev_perm(n)).all()


@pytest.mark.parametrize("demont", [False, True])
def test_h_pipeline_split_matches_monolithic(demont):
    n = 32
    jevs, evs = _evals(n, 77, rows=3)
    rng = random.Random(78)
    tinv = torch.as_tensor(FR.to_mont([rng.randrange(1, R)])[0])
    tables = td.tables(n, "cpu")
    a = tp._h_pipeline(evs, tinv, tables, demont)
    b = tp._h_pipeline_split(evs, tinv, tables, demont)
    assert (a == b).all()
    if demont:          # the MSM-ready form the prover uses
        _same(jpt._h_pipeline(jevs,
                              jnp.asarray(tinv.numpy().astype(np.uint32)),
                              jd.tables_device(n), demont), a)


def test_unpack_mont_fr_matches_jax():
    rng = random.Random(9)
    vals = [rng.randrange(R) for _ in range(33)]
    from tpu_zkpool_torch.fields.limbs import ints_to_limbs, pack_limbs16
    packed = pack_limbs16(ints_to_limbs(vals))
    _same(jpt._unpack_mont_fr(jnp.asarray(packed)),
          tp._unpack_mont_fr(packed, "cpu"))
    _same(jnp.asarray(JFR.to_mont(np.asarray(vals, dtype=object))),
          tp._unpack_mont_fr(packed, "cpu"))
