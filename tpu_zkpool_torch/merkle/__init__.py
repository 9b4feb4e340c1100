"""Depth-16 Poseidon Merkle tree, levels built through kernel K7."""

from tpu_zkpool_torch.merkle.tree import (TREE_DEPTH, MerkleTree, build_levels,
                                          default_hashes)

__all__ = ["TREE_DEPTH", "MerkleTree", "build_levels", "default_hashes"]
