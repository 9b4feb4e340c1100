"""Port parity: the sharded negacyclic NTT and K9's twin.

On a CPU ``Mesh.virtual`` every shard is a CPU tensor, so the cross-shard
stages run K9's plain twin, one stage over every slot, eagerly (a CUDA
mesh replays a graph of the same code). These tests hold the twin to the
JAX package's ``ntt_rdma._butterfly``, and the sharded transforms at D =
2, 4, 8 under both exchanges to the single-device NTT, JAX's
``forward_sharded`` on the 8-device virtual CPU mesh (once, with
``exchange="rdma", interpret=True``) and the schoolbook product;
``test_torch_k9_stage.py`` holds the all-slot stage in both forms. K9
itself is held to the twin on the card by ``chip_smoke.py`` and
``test_torch_kernels_cuda.py``. Exact integers: the tolerance is zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.parallel import ntt_rdma as j_rdma
from tpu_zkpool.parallel import ntt_sharded as j_sharded
from tpu_zkpool.refimpl import rlwe_ref as j_rlwe_ref
from tpu_zkpool.rlwe import ntt as jn

from tpu_zkpool_torch.fields import rlweq as tq
from tpu_zkpool_torch.parallel import (Mesh, forward_sharded, inverse_sharded,
                                       negacyclic_mul_sharded, ntt_rdma)
from tpu_zkpool_torch.parallel import ntt_sharded as t_sharded
from tpu_zkpool_torch.refimpl import rlwe_ref

Q = tq.Q
N = 1024
B = 101                       # an odd row count


def _q(shape, seed):
    return np.random.default_rng(seed).integers(0, Q, shape, dtype=np.uint32)


@pytest.mark.parametrize("u_side", [0, 1])
def test_butterfly_plain_matches_jax(u_side):
    y, other, tw = _q((8, 128), 1), _q((8, 128), 2), _q((128,), 3)
    y[0, :3], other[0, :3], tw[:3] = [0, 1, Q - 1], [Q - 1, 0, Q - 1], [0, 1,
                                                                        Q - 1]
    want = np.asarray(j_rdma._butterfly(jnp.asarray(y), jnp.asarray(other),
                                        jnp.asarray(tw), jnp.int32(u_side)))
    got = ntt_rdma.butterfly(tq.from_numpy_u32(y, device="cpu"),
                             tq.from_numpy_u32(other, device="cpu"),
                             tq.from_numpy_u32(tw, device="cpu"), u_side)
    assert (tq.to_numpy_u32(got) == want).all()


def test_local_slices_match_jax():
    for D in (2, 4, 8):
        for j, t in zip(j_sharded._local_slices(N, D),
                        t_sharded._local_slices(N, D)):
            if isinstance(j, list):
                assert all((x == y).all() for x, y in zip(j, t))
            else:
                assert j.shape == t.shape == (D, N // D) and (j == t).all()


@functools.lru_cache(maxsize=None)
def _reference():
    """Inputs and the single-device JAX results (jitted, once a worker),
    and the schoolbook product of row 0."""
    a, b = _q((B, N), 31), _q((B, N), 32)
    a[0, :3] = [0, 1, Q - 1]
    fwd = np.asarray(jax.jit(jn.forward)(jnp.asarray(a)))
    mul = np.asarray(jax.jit(jn.negacyclic_mul)(jnp.asarray(a),
                                                 jnp.asarray(b)))
    school = rlwe_ref.negacyclic_mul([int(v) for v in a[0]],
                                     [int(v) for v in b[0]])
    return a, b, fwd, mul, school


@pytest.mark.parametrize("exchange", ["ppermute", "rdma"])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_sharded_transforms_match_single_device(D, exchange):
    a, b, fwd, mul, school = _reference()
    mesh = Mesh.virtual((D,), ("sp",), device="cpu")
    ta = tq.from_numpy_u32(a, device="cpu")
    tb = tq.from_numpy_u32(b, device="cpu")
    f = forward_sharded(ta, mesh, exchange=exchange)
    assert (tq.to_numpy_u32(f) == fwd).all()
    assert torch.equal(inverse_sharded(f, mesh, exchange=exchange), ta)
    p = tq.to_numpy_u32(negacyclic_mul_sharded(ta, tb, mesh,
                                               exchange=exchange))
    assert (p == mul).all()
    assert [int(v) for v in p[0]] == school


def test_sharded_forward_matches_jax_sharded_rdma():
    """JAX's forward_sharded on the 8-device virtual CPU mesh, with the
    Pallas RDMA kernel in interpret mode, against the port's at D = 8
    under both exchanges (and the schoolbook oracle's ring)."""
    assert rlwe_ref.RLWE_Q == j_rlwe_ref.RLWE_Q and rlwe_ref.N == N
    x = _q((8, N), 41)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    want = np.asarray(j_sharded.forward_sharded(
        jnp.asarray(x), mesh, exchange="rdma", interpret=True))
    tmesh = Mesh.virtual((8,), ("sp",), device="cpu")
    for exchange in ("ppermute", "rdma"):
        got = forward_sharded(tq.from_numpy_u32(x, device="cpu"), tmesh,
                              exchange=exchange)
        assert (tq.to_numpy_u32(got) == want).all()
