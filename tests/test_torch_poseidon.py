"""Port parity: ``tpu_zkpool_torch.hash`` against ``tpu_zkpool.hash``.

The same seeded values go through the JAX XLA ``hash_n`` (eager, on the
CPU) and the port's ``hash_n`` on the CPU, which runs K7's plain twin; the
port's int64 limbs must equal the JAX uint32 limbs exactly. The JAX Pallas
kernel cannot run on the CPU; the XLA module computes the same function.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.hash import poseidon as jp
from tpu_zkpool.hash.poseidon_params import poseidon_hash_ref as jax_ref

from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.hash import kernels, poseidon
from tpu_zkpool_torch.hash.poseidon_params import poseidon_hash_ref

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _inputs(t, seed, B=8):
    """B rows of t - 1 field elements, the first three rows 0, 1 and r - 1."""
    r = FR.modulus
    rng = random.Random(seed)
    rows = [[rng.randrange(r) for _ in range(t - 1)] for _ in range(B)]
    rows[:3] = [[0] * (t - 1), [1] * (t - 1), [r - 1] * (t - 1)]
    return rows, FR.to_mont(np.asarray(rows, dtype=object))


@pytest.mark.parametrize("t", [3, 4, 5])
def test_tables_match_jax(t):
    mine = poseidon._mont_tables(t)
    theirs = jp._mont_tables(t)
    for a, b in zip(mine, theirs):
        assert a.dtype == np.int64 and (a == b.astype(np.int64)).all()
    own = poseidon.tables(t, CPU)
    loaded = poseidon.load_tables(theirs, device="cpu")
    assert own.rc.shape == (8 + [57, 56, 60][t - 3], t, 16)
    assert torch.equal(own.rc, loaded.rc) and torch.equal(own.m, loaded.m)


@pytest.mark.parametrize("t", [3, 4, 5])
def test_hash_n_matches_jax(t):
    rows, limbs = _inputs(t, seed=t)
    want = np.asarray(jp.hash_n(jnp.asarray(limbs.astype(np.uint32))))
    got = poseidon.hash_n(torch.as_tensor(limbs))
    assert (got.numpy() == want.astype(np.int64)).all()
    assert [int(v) for v in FR.from_mont(got)] == [
        poseidon_hash_ref(row) for row in rows]


def test_hash_wrappers_match_reference():
    rows, limbs = _inputs(5, seed=11, B=6)
    x = torch.as_tensor(limbs)
    cols = [x[:, i] for i in range(4)]
    ref2 = [poseidon_hash_ref(row[:2]) for row in rows]
    ref4 = [poseidon_hash_ref(row) for row in rows]
    assert [int(v) for v in FR.from_mont(poseidon.hash2(*cols[:2]))] == ref2
    assert [int(v) for v in FR.from_mont(kernels.hash2_kernel(*cols[:2]))] == ref2
    assert [int(v) for v in FR.from_mont(poseidon.hash3(*cols[:3]))] == [
        poseidon_hash_ref(row[:3]) for row in rows]
    assert [int(v) for v in FR.from_mont(kernels.hash4_kernel(*cols))] == ref4
    # broadcast: one left operand against a batch
    assert torch.equal(poseidon.hash2(cols[0][0], cols[1]),
                       poseidon.hash2(cols[0][:1].expand(6, 16), cols[1]))


def test_hash_ints_and_circomlib_vector():
    assert poseidon_hash_ref([1, 2]) == jax_ref([1, 2]) == (
        7853200120776062878684798364095072458815029376092732009249414926327459813530)
    got = poseidon.hash_ints([1, 0, 7], [2, 0, 9], device="cpu")
    assert list(got) == [jax_ref([a, b]) for a, b in ((1, 2), (0, 0), (7, 9))]
    # leading axes: (2, 3, 2, 16) inputs hash to (2, 3, 16), row by row
    _, limbs = _inputs(3, seed=5, B=6)
    x = torch.as_tensor(limbs)
    got = poseidon.hash_n(x.reshape(2, 3, 2, 16))
    assert got.shape == (2, 3, 16)
    assert torch.equal(got.reshape(6, 16), poseidon.hash_n(x))
