"""Port parity: RLWE keygen / encrypt / decrypt (``tpu_zkpool_torch.rlwe.
encrypt``) and the quotient witnesses (``rlwe.quotient``) against
``tpu_zkpool.rlwe`` and the oracles of ``refimpl.rlwe_ref``, exact.

The same numpy arrays (mod-q words as uint32) reach both packages; the port
takes them through the carry-across ``rlweq.from_numpy_u32``. The key is
``rlwe_ref.keygen(42)``, the noise ``rlwe_ref.encrypt(seed=999)``'s (and
seed 1000's for a batch of two).
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.rlwe import encrypt as jenc
from tpu_zkpool.rlwe import quotient as jquot

from tpu_zkpool_torch.fields import rlweq
from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.refimpl import rlwe_ref
from tpu_zkpool_torch.rlwe import encrypt as enc
from tpu_zkpool_torch.rlwe import quotient

torch.set_num_threads(1)

Q = rlwe_ref.RLWE_Q
OWNERS = [
    (0x13C1A5D58F3CE2659C8CB9F6686264197864954B53A3BA1EDA4168B9B18927B8,
     0x1D1E2A6A28D810BC04992F6E8F890F1D9CAD471819BC111AE229B507F4D77A0F),
    (3, 5),
]


@functools.lru_cache(maxsize=None)
def _key():
    return rlwe_ref.keygen(42)


@functools.lru_cache(maxsize=None)
def _encs():
    kg = _key()
    return [rlwe_ref.encrypt(kg["a"], kg["b"], x, y, seed=999 + i)
            for i, (x, y) in enumerate(OWNERS)]


def _q(vals):
    """Signed or mod-q ints -> the shared numpy uint32 words."""
    return np.asarray([v % Q for v in vals], dtype=np.uint32)


def _port(words):
    return rlweq.from_numpy_u32(words, device="cpu")


def _inputs():
    """(pk_a, pk_b, r, e1, e2, delta_msg) as numpy uint32, batched over the
    two encryptions."""
    kg, es = _key(), _encs()
    dm = np.stack([enc.encode_message(x, y).astype(np.int64) * rlwe_ref.DELTA
                   for x, y in OWNERS]).astype(np.uint32)
    return (_q(kg["a"]), _q(kg["b"]),
            np.stack([_q(e["r_signed"]) for e in es]),
            np.stack([_q(e["e1_signed"]) for e in es]),
            np.stack([_q(e["e2_signed"]) for e in es]), dm)


def test_keygen_equals_jax_and_reference():
    kg = _key()
    sk, a, e = _q(kg["sk_signed"]), _q(kg["a"]), _q(kg["e_signed"])
    got = enc.keygen_from_randomness(_port(sk), _port(a), _port(e))
    want = np.asarray(jenc.keygen_from_randomness(
        jnp.asarray(sk), jnp.asarray(a), jnp.asarray(e)))
    assert rlweq.to_numpy_u32(got).tolist() == want.tolist() == kg["b"]


def test_encrypt_equals_jax_and_reference():
    ins = _inputs()
    c0, c1 = enc.encrypt_core(*(_port(x) for x in ins))
    j0, j1 = jenc.encrypt_core(*(jnp.asarray(x) for x in ins))
    assert (rlweq.to_numpy_u32(c0) == np.asarray(j0)).all()
    assert (rlweq.to_numpy_u32(c1) == np.asarray(j1)).all()
    for i, e in enumerate(_encs()):
        assert c0[i].tolist() == e["c0_sparse"] and c1[i].tolist() == e["c1"]


def test_decrypt_equals_jax_and_reference():
    kg, es = _key(), _encs()
    sk = _q(kg["sk_signed"])
    c0 = np.stack([_q(e["c0_sparse"]) for e in es])
    c1 = np.stack([_q(e["c1"]) for e in es])
    got = enc.decrypt_core(_port(sk), _port(c0), _port(c1))
    want = np.asarray(jenc.decrypt_core(jnp.asarray(sk), jnp.asarray(c0),
                                        jnp.asarray(c1)))
    assert (got.numpy() == want.astype(np.int64)).all()
    for i, e in enumerate(es):
        assert got[i].tolist() == rlwe_ref.decrypt(
            sk.tolist(), e["c0_sparse"], e["c1"])
        assert enc.decode_message(got[i]) == OWNERS[i]


def test_decrypt_ties_to_even():
    """With sk = 0 the noisy value is c0 itself: exact halves k Delta +
    Delta / 2 of either sign round to the even neighbour, as Python's
    round() does; values one off a half round as usual."""
    half = rlwe_ref.DELTA // 2
    centred = []
    for k in (-128, -7, -2, -1, 0, 1, 2, 3, 126, 127):
        centred += [k * rlwe_ref.DELTA + half, k * rlwe_ref.DELTA - half,
                    k * rlwe_ref.DELTA + half + 1, k * rlwe_ref.DELTA - half - 1]
    centred = [c for c in centred if -Q // 2 < c <= Q // 2]
    centred += [0] * (rlwe_ref.MSG_SLOTS - len(centred))
    assert len(centred) == rlwe_ref.MSG_SLOTS
    c0 = _q(centred)
    sk = np.zeros(rlwe_ref.N, np.uint32)
    c1 = _q(random.Random(5).randrange(Q) for _ in range(rlwe_ref.N))
    got = enc.decrypt_core(_port(sk), _port(c0), _port(c1))
    want = np.asarray(jenc.decrypt_core(jnp.asarray(sk), jnp.asarray(c0),
                                        jnp.asarray(c1)))
    assert got.tolist() == want.tolist() == rlwe_ref.decrypt(
        [0] * rlwe_ref.N, c0.tolist(), c1.tolist())
    assert got.tolist() == [round(c / rlwe_ref.DELTA) % 256 for c in centred]


@pytest.mark.parametrize("rows", ["c1", "c0"])
def test_quotient_witnesses_equal_jax_and_reference(rows):
    kg, es = _key(), _encs()
    r = np.stack([np.asarray(e["r_signed"], np.int8) for e in es])
    if rows == "c1":
        pk = kg["a"]
        extra = np.stack([np.asarray(e["e2_signed"]) for e in es])
    else:
        pk = kg["b"]
        extra = np.stack([np.asarray(
            [e["e1_signed"][i] + rlwe_ref.DELTA * e["msg"][i]
             for i in range(rlwe_ref.MSG_SLOTS)]
            + [0] * (rlwe_ref.N - rlwe_ref.MSG_SLOTS)) for e in es])
    k, rem = quotient.quotient_witnesses(pk, torch.as_tensor(r),
                                         torch.as_tensor(extra))
    jk, jrem = jquot.quotient_witnesses(pk, r, extra)
    assert (k.numpy() == jk).all() and (rem.numpy() == jrem).all()
    m = rlwe_ref.N if rows == "c1" else rlwe_ref.MSG_SLOTS
    for i, e in enumerate(es):
        assert k[i, :m].tolist() == e["k1" if rows == "c1" else "k0"]
        assert rem[i, :m].tolist() == e[rows if rows == "c1" else "c0_sparse"]
    assert (k < 0).any() and (k > 0).any()


def test_limb_matrices_equal_jax():
    pk = _key()["a"]
    got = quotient._negacyclic_limb_matrices(tuple(pk))
    want = jquot._negacyclic_limb_matrices(tuple(pk))
    assert all((g == w).all() for g, w in zip(got, want))
    mat = sum(g.astype(np.int64) << (7 * l) for l, g in enumerate(got))
    for k in (0, 1, 511, 1023):
        assert mat[k].tolist() == rlwe_ref.negacyclic_matrix_row(pk, k)


def test_centered_mod_q_equals_reference():
    p = FR.modulus
    rng = random.Random(17)
    vals = [0, 1, 2, 3, p - 1, p - 2, p - 3, (p - 1) // 2, (p + 1) // 2,
            Q, p - Q] + [rng.randrange(p) for _ in range(40)]
    x = torch.as_tensor(FR.to_mont(np.asarray(vals, dtype=object)))
    assert enc.centered_mod_q(x).tolist() == [
        rlwe_ref.centered_mod(v, p) % Q for v in vals]
