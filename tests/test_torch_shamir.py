"""Port parity: Shamir sharing (``tpu_zkpool_torch.shamir``) against
``tpu_zkpool.shamir`` and ``refimpl.rlwe_ref.shamir_share_field`` /
``shamir_reconstruct_field``, exact, for every pair of shares.

The secrets are ``rlwe_ref.keygen(42)``'s key coefficients (as Fr), the
random coefficients those implied by keygen's first share list; the same
numpy limbs reach both packages (the port through ``limbs.from_jax``).
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_zkpool.fields.fctx import FR as JFR
from tpu_zkpool.shamir import reconstruct_batch as jreconstruct
from tpu_zkpool.shamir import share_batch as jshare

from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.fields.limbs import from_jax
from tpu_zkpool_torch.refimpl import rlwe_ref
from tpu_zkpool_torch.shamir import reconstruct_batch, share_batch

P = FR.modulus
PAIRS = [(1, 2), (1, 3), (2, 3)]


@functools.lru_cache(maxsize=None)
def _key_shares():
    """(secrets, coefficients, shares) as ints: keygen's sk mod r, the
    degree-1 coefficient each share list implies, keygen's 3 share lists."""
    kg = rlwe_ref.keygen(42)
    sk = [v % P for v in kg["sk_signed"]]
    coeff = [(y - s) % P for (_, y), s in zip(kg["shares"][0], sk)]
    return sk, coeff, [[y for _, y in sh] for sh in kg["shares"]]


def _ints(t):
    return [[int(v) for v in row] for row in FR.from_mont(t)]


def test_share_batch_equals_jax_and_keygen():
    sk, coeff, shares = _key_shares()
    s_j = JFR.to_mont(np.asarray(sk, dtype=object))
    c_j = JFR.to_mont(np.asarray([coeff], dtype=object))
    got = share_batch(from_jax(s_j, device="cpu"), from_jax(c_j, device="cpu"))
    want = np.asarray(jshare(jnp.asarray(s_j), jnp.asarray(c_j)))
    assert (got.numpy() == want.astype(np.int64)).all()
    assert _ints(got) == shares


@pytest.mark.parametrize("xs", PAIRS)
def test_reconstruct_batch_equals_jax_and_reference(xs):
    sk, _, shares = _key_shares()
    ys = JFR.to_mont(np.asarray([shares[x - 1] for x in xs], dtype=object))
    got = reconstruct_batch(from_jax(ys, device="cpu"), xs)
    want = np.asarray(jreconstruct(jnp.asarray(ys), xs))
    assert (got.numpy() == want.astype(np.int64)).all()
    assert [int(v) for v in FR.from_mont(got)] == sk
    for i in (0, 1, 2, 1023):
        assert rlwe_ref.shamir_reconstruct_field(
            [(x, shares[x - 1][i]) for x in xs]) == sk[i]


@pytest.mark.parametrize("xs", PAIRS)
def test_random_secrets_share_and_reconstruct(xs):
    """Random Fr secrets split by the oracle's draw order, then any two
    shares give them back, on the port and against the oracle."""
    rng = random.Random(31 + xs[0] * 3 + xs[1])
    secrets = [rng.choice([0, 1, P - 1, rng.randrange(P)]) for _ in range(24)]
    ref = [rlwe_ref.shamir_share_field(s, rng) for s in secrets]
    coeff = [(sh[0][1] - s) % P for sh, s in zip(ref, secrets)]
    got = share_batch(
        from_jax(JFR.to_mont(np.asarray(secrets, dtype=object)), "cpu"),
        from_jax(JFR.to_mont(np.asarray([coeff], dtype=object)), "cpu"))
    assert _ints(got) == [[sh[k][1] for sh in ref] for k in range(3)]
    back = reconstruct_batch(got[[x - 1 for x in xs]], xs)
    assert [int(v) for v in FR.from_mont(back)] == secrets == [
        rlwe_ref.shamir_reconstruct_field([sh[x - 1] for x in xs])
        for sh in ref]
