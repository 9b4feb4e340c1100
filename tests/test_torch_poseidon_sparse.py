"""The sparse form of Poseidon that K7 runs, held to the dense form.

``poseidon.sparse_form`` derives the tables of the Poseidon paper's
appendix B (a dense pre-matrix, one constant and a matrix of 2t - 1 entries
a partial round) exactly over Fr from the port's dense constants. The same
seeded inputs, with 0, 1 and r - 1 planted, go through the sparse-form
permutation below (plain torch, the rounds as ``csrc/poseidon.cu`` runs
them), the dense twin ``hash_n_plain`` and the JAX XLA ``hash_n`` (eager,
on the CPU); all three must give the same limbs. The kernel's packed word
tables must hold the same values.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.hash import poseidon as jp

from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.fields.limbs import NLIMB
from tpu_zkpool_torch.hash import poseidon
from tpu_zkpool_torch.hash.poseidon_params import (N_ROUNDS_F, N_ROUNDS_P,
                                                   poseidon_hash_ref)

torch.set_num_threads(1)


def hash_n_sparse(inputs):
    """Poseidon of int64[B, t - 1, 16] Montgomery inputs -> [B, 16] in the
    sparse form of ``poseidon.sparse_form``: full rounds mix with m (the
    last of the first half with pre), partial rounds add k to wire 0 and
    mix out_0 = w s_0 + sum v_j s_j, out_i = u_i s_0 + s_i."""
    t = inputs.shape[-2] + 1
    sf = poseidon.sparse_form(t)
    c_full, k, m, pre, sparse = (torch.as_tensor(FR.to_mont(np.array(
        v, dtype=object))) for v in (sf.c_full, sf.k, sf.m, sf.pre,
                                     sf.sparse))
    x5, mix = poseidon._x5, poseidon._mix
    state = torch.cat([inputs.new_zeros(inputs.shape[:-2] + (1, NLIMB)),
                       inputs], -2)
    half, r_p = N_ROUNDS_F // 2, N_ROUNDS_P[t - 2]
    for r in range(half):
        state = mix(x5(FR.add(state, c_full[r])), pre if r == half - 1
                    else m)
    for r in range(r_p):
        s0 = x5(FR.add(state[..., 0, :], k[r]))
        rest = state[..., 1:, :]
        w, v, u = sparse[r, 0], sparse[r, 1:t], sparse[r, t:]
        acc = FR.mont_mul(w, s0)
        for j in range(t - 1):
            acc = FR.add(acc, FR.mont_mul(v[j], rest[..., j, :]))
        rest = FR.add(rest, FR.mont_mul(u, s0[..., None, :]))
        state = torch.cat([acc[..., None, :], rest], -2)
    for r in range(half, N_ROUNDS_F):
        state = mix(x5(FR.add(state, c_full[r])), m)
    return state[..., 0, :]


def _inputs(t, seed, B=6):
    """B rows of t - 1 field elements: rows of 0, 1 and r - 1, one row
    mixing them, the rest seeded."""
    r = FR.modulus
    rng = random.Random(seed)
    rows = [[rng.randrange(r) for _ in range(t - 1)] for _ in range(B)]
    rows[:4] = [[0] * (t - 1), [1] * (t - 1), [r - 1] * (t - 1),
                [(0, 1, r - 1)[w % 3] for w in range(t - 1)]]
    return rows, FR.to_mont(np.asarray(rows, dtype=object))


@pytest.mark.parametrize("t", [2, 3, 5, 17])
def test_sparse_form_matches_dense_and_jax(t):
    rows, limbs = _inputs(t, seed=40 + t)
    x = torch.as_tensor(limbs)
    got = hash_n_sparse(x)
    assert torch.equal(got, poseidon.hash_n_plain(x))
    want = np.asarray(jp.hash_n(jnp.asarray(limbs.astype(np.uint32))))
    assert (got.numpy() == want.astype(np.int64)).all()
    assert [int(v) for v in FR.from_mont(got[:2])] == [
        poseidon_hash_ref(row) for row in rows[:2]]


@pytest.mark.parametrize("t", [2, 3, 5, 17])
def test_sparse_tables_shape_and_words(t):
    sf = poseidon.sparse_form(t)
    r_p = N_ROUNDS_P[t - 2]
    assert len(sf.c_full) == N_ROUNDS_F and len(sf.k) == r_p
    assert all(len(row) == 2 * t - 1 for row in sf.sparse)
    # the mixes of the first half: M three times, then the pre-matrix
    assert sf.m != sf.pre
    words = poseidon.kernel_tables(t, torch.device("cpu"))
    vals = [x for row in sf.c_full for x in row] + sf.k + [
        x for mat in (sf.m, sf.pre, sf.sparse) for row in mat for x in row]
    assert words.dtype == torch.int32 and words.shape == (len(vals), 8)
    u = words.numpy().view(np.uint32).astype(object)
    mont = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in u]
    assert mont == [v * (1 << 256) % FR.modulus for v in vals]


def test_sparse_form_circomlib_vector():
    x = torch.as_tensor(FR.to_mont(np.asarray([[0, 0]], dtype=object)))
    got = int(FR.from_mont(hash_n_sparse(x))[0])
    assert hex(got).startswith("0x2098f5fb")
    assert got == poseidon_hash_ref([0, 0])
