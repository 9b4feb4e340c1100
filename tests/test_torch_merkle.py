"""Port parity: ``tpu_zkpool_torch.merkle`` against ``tpu_zkpool.merkle``.

The JAX tree is fed the same leaves through its host path (inserts, the
frontier root); its ``build_levels`` is not compiled here. The port's tree
runs on ``device="cpu"``, where each level is one call of K7's plain twin.
"""

import random

import numpy as np
import pytest
import torch

from tpu_zkpool.hash.poseidon_params import poseidon_hash_ref as jax_ref
from tpu_zkpool.merkle import MerkleTree as JaxTree
from tpu_zkpool.merkle import default_hashes as jax_default_hashes

from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.hash.poseidon_params import poseidon_hash_ref as H
from tpu_zkpool_torch.merkle import MerkleTree, build_levels, default_hashes

import vectors

torch.set_num_threads(1)


def test_default_hashes_match_jax_and_siblings():
    dh = default_hashes(16)
    assert dh == jax_default_hashes(16)
    assert list(dh[:16]) == vectors.SIBLINGS


def test_single_leaf_root_and_proof_match_committed():
    commitment = H([vectors.OWNER_X, vectors.OWNER_Y, vectors.AMOUNT,
                    vectors.RANDOMNESS])
    t = MerkleTree(device="cpu")
    assert t.insert(commitment) == 0
    assert t.get_root() == vectors.ROOT
    assert t.get_proof(0) == vectors.SIBLINGS


@pytest.mark.parametrize("n", [5, 8])
def test_tree_matches_jax(n):
    rng = random.Random(n)
    leaves = [rng.randrange(FR.modulus) for _ in range(n)]
    mine, theirs = MerkleTree(device="cpu"), JaxTree()
    for v in leaves:
        assert mine.insert(v) == theirs.insert(v)
    assert mine.leaves == theirs.leaves
    assert mine._filled == theirs._filled
    assert mine.get_root() == theirs.get_root()
    # the levels of the JAX tree's leaves, hashed by the JAX package's host
    # oracle (its device build_levels is not compiled here)
    levels = [theirs.leaves + [0] * (8 - n)]
    while len(levels[-1]) > 1:
        lv = levels[-1]
        levels.append([jax_ref([lv[i], lv[i + 1]])
                       for i in range(0, len(lv), 2)])
    root = mine.get_root()
    for i, leaf in enumerate(leaves):
        proof = mine.get_proof(i)
        assert proof[:3] == [levels[k][(i >> k) ^ 1] for k in range(3)]
        assert proof[3:] == list(jax_default_hashes(16)[3:16])
        assert MerkleTree.verify_proof(leaf, i, proof, root), i
        assert JaxTree.verify_proof(leaf, i, proof, theirs.get_root())
    bad = mine.get_proof(2)
    bad[1] = (bad[1] + 1) % FR.modulus
    assert not MerkleTree.verify_proof(leaves[2], 2, bad, root)


def test_build_levels_root_equals_frontier_root():
    rng = random.Random(3)
    leaves = [rng.randrange(FR.modulus) for _ in range(8)]
    t = MerkleTree(device="cpu")
    for v in leaves:
        t.insert(v)
    x = torch.as_tensor(FR.to_mont(np.asarray(leaves, dtype=object)))
    levels, root = build_levels(x, 16)
    assert [lv.shape[0] for lv in levels] == [8, 4, 2, 1]
    assert int(FR.from_mont(root)) == t.get_root()
    assert int(FR.from_mont(levels[-1][0])) == t._levels()[3][0]
    with pytest.raises(ValueError, match="power of two"):
        build_levels(x[:6], 16)
