"""Port parity: the point-sharded, 2-D and leg-parallel MSMs, the
hierarchical fold and the dp-sharded Merkle root, on CPU ``Mesh.virtual``
meshes.

Each slot runs the kernels' plain twins on its point shard; the results are
held to the native Pippenger oracle in affine form (the JAX package's
sharded MSMs compile for minutes on the CPU, so its own tests hold them to
the same oracle), as ``tests/test_parallel.py`` does, with small lanes and
narrow scalars (``nbits``) so that each slot's window sums stay cheap. The
Merkle root is held to the JAX tree's host path.
"""

import random

import numpy as np
import pytest
import torch

from tpu_zkpool import native_bridge as jnb
from tpu_zkpool.merkle import MerkleTree as JaxTree

from tpu_zkpool_torch.fields.fctx import FP, FR
from tpu_zkpool_torch.fields.limbs import ints_to_limbs
from tpu_zkpool_torch.groth16 import prove as tp
from tpu_zkpool_torch.parallel import Mesh, msm_grid_sharded
from tpu_zkpool_torch.parallel.merkle_sharded import root_sharded
from tpu_zkpool_torch.parallel.msm_sharded import msm_grid_sharded_2d
from tpu_zkpool_torch.parallel.multihost import hierarchical_fold
from tpu_zkpool_torch.parallel.prove_stages import msm_legs_sharded

torch.set_num_threads(1)

C, NBITS, LANES = 5, 20, 32     # 4 windows of 16 buckets, 32 lanes a slot


def _inputs(n, seed):
    """n affine G1 points (one identity, one repeat) as Jacobian rows
    (n, 3, 1, 16), scalars < 2^(NBITS-1) as limbs, and the oracle's point."""
    rng = random.Random(seed)
    pts = jnb.g1_gen_mul_batch([rng.randrange(1, 1 << 62) for _ in range(n)])
    pts[5] = pts[6]
    ks = [rng.randrange(1 << (NBITS - 1)) for _ in range(n)]
    rows = [[[x], [y], [1]] for x, y in pts]
    rows[3] = [[0], [0], [0]]                        # the identity
    want = jnb.g1_msm([k for i, k in enumerate(ks) if i != 3],
                      [p for i, p in enumerate(pts) if i != 3])
    return (torch.as_tensor(FP.to_mont(rows)),
            torch.as_tensor(ints_to_limbs(ks)), want)


def _affine(row):
    return tp._g1_affine(tuple(row[i, 0] for i in range(3)))


@pytest.mark.parametrize("D", [2, 4])
def test_msm_grid_sharded_vs_native(D):
    rows, limbs, want = _inputs(2 * LANES * D, 40 + D)
    mesh = Mesh.virtual((D,), ("dp",), device="cpu")
    out = msm_grid_sharded(rows, limbs, mesh, c=C, lanes=LANES, nbits=NBITS)
    assert out.shape == (3, 1, 16)
    assert _affine(out) == want


def test_msm_grid_sharded_2d_vs_native():
    rows, limbs, want = _inputs(2 * LANES * 4, 47)
    mesh = Mesh.virtual((2, 2), ("host", "chip"), device="cpu")
    assert _affine(msm_grid_sharded_2d(rows, limbs, mesh, c=C, lanes=LANES,
                                       nbits=NBITS)) == want


def test_hierarchical_fold_virtual_pod():
    """The (2 hosts x 4 chips) fold: chip axis first, then one partial a
    host, as tests/test_parallel.py::test_hierarchical_fold_virtual_pod."""
    mesh = Mesh.virtual((2, 4), ("host", "chip"), device="cpu")
    x = torch.arange(8.)
    parts = mesh.shard(x, (("host", "chip"),))
    out = hierarchical_fold(lambda a, b: a + b, parts, mesh)
    assert float(out[0]) == float(x.sum())


def test_msm_legs_sharded_vs_native():
    legs = [_inputs(LANES * 2, 60 + i) for i in range(4)]
    mesh = Mesh.virtual((4, 2), ("leg", "pt"), device="cpu")
    out = msm_legs_sharded(torch.stack([r for r, _, _ in legs]),
                           torch.stack([l for _, l, _ in legs]), mesh,
                           c=C, lanes=LANES, nbits=NBITS)
    assert out.shape == (4, 3, 1, 16)
    assert [_affine(out[i]) for i in range(4)] == [w for _, _, w in legs]


def test_root_sharded_matches_jax_tree():
    """8 leaves over 2 dp shards in a depth-5 tree (the combine, then two
    default-hash folds) against the JAX tree's frontier root."""
    rng = random.Random(70)
    leaves = [rng.randrange(FR.modulus) for _ in range(8)]
    jt = JaxTree(depth=5)
    for v in leaves:
        jt.insert(v)
    mesh = Mesh.virtual((2,), ("dp",), device="cpu")
    root = root_sharded(torch.as_tensor(FR.to_mont(np.asarray(
        leaves, dtype=object))), mesh, depth=5)
    assert int(FR.from_mont(root)) == jt.get_root()
