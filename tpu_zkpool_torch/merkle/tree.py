"""Depth-16 Poseidon Merkle tree with batched level hashing, in torch.

The port of ``tpu_zkpool/merkle/tree.py``, with the same semantics as the
pool's client tree: 2-ary, empty leaf = 0, default hash chain d_0 = 0,
d_{k+1} = poseidon2(d_k, d_k); proofs are sibling lists from leaf to root.

A whole level is one batched Poseidon call (pairs on the batch axis), so a
full build of 2^16 leaves is 16 calls, each one launch of kernel K7 when the
leaves are on the GPU. ``MerkleTree`` keeps a frontier of filled subtrees on
the host (O(log N) reference hashes per insert, O(1) roots); proofs read the
levels, rebuilt on the tree's device after each insert.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.hash import poseidon
from tpu_zkpool_torch.hash.poseidon_params import poseidon_hash_ref

TREE_DEPTH = 16


@functools.lru_cache(maxsize=None)
def default_hashes(depth: int = TREE_DEPTH) -> tuple:
    """d_0 = 0, d_{k+1} = H(d_k, d_k), as Python ints (host constants)."""
    out = [0]
    for _ in range(depth):
        out.append(poseidon_hash_ref([out[-1], out[-1]]))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _default_mont(depth: int = TREE_DEPTH) -> np.ndarray:
    return FR.to_mont(np.asarray(default_hashes(depth), dtype=object))


def build_levels(leaves: torch.Tensor, depth: int = TREE_DEPTH):
    """Build every tree level from int64[N, 16] Montgomery leaves, on the
    leaves' device.

    N must be a power of two <= 2^depth; missing subtrees fold in through
    the default-hash chain. Returns (levels, root): level_k is (N >> k, 16)
    for k = 0..log2(N), and root (16,) is the top node folded up to
    ``depth``."""
    n = leaves.shape[0]
    if n < 1 or n & (n - 1) or n > 1 << depth:
        raise ValueError(f"leaf count must be a power of two <= 2^{depth}, "
                         f"got {n}")
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = poseidon.hash2(cur[0::2], cur[1::2])
        levels.append(cur)
    root = cur[0]
    if len(levels) - 1 < depth:
        # a host copy syncs the current stream: only when defaults fold in
        dmont = torch.as_tensor(_default_mont(depth), device=leaves.device)
        for j in range(len(levels) - 1, depth):
            root = poseidon.hash2(root, dmont[j])
    return levels, root


class MerkleTree:
    """Incremental append-only tree mirroring ``ShieldedPoolMerkleTree``.

    Holds canonical-int leaves on the host. ``insert`` updates the frontier
    of filled subtrees (``depth`` host hashes); ``get_root`` reads the
    frontier root; ``get_proof`` reads the levels, which ``_levels`` builds
    on the tree's device (default ``cuda``) once after each insert.
    """

    def __init__(self, depth: int = TREE_DEPTH, device=None):
        self.depth = depth
        self.device = resolve_device(device)
        self.leaves: list[int] = []
        self._levels_cache = None
        self._filled: list[int] = [0] * depth   # left sibling per level
        self._root: int = default_hashes(depth)[depth]

    def insert(self, commitment: int) -> int:
        """Append a leaf: one frontier pass of ``depth`` host hashes."""
        index = len(self.leaves)
        leaf = commitment % FR.modulus
        self.leaves.append(leaf)
        self._levels_cache = None
        dh = default_hashes(self.depth)
        cur, i = leaf, index
        for k in range(self.depth):
            if i % 2 == 0:
                self._filled[k] = cur
                cur = poseidon_hash_ref([cur, dh[k]])
            else:
                cur = poseidon_hash_ref([self._filled[k], cur])
            i //= 2
        self._root = cur
        return index

    # ------------------------------------------------------------------

    def _padded_leaf_count(self) -> int:
        n = max(1, len(self.leaves))
        p = 1
        while p < n:
            p <<= 1
        return p

    def _levels(self):
        """Every level as canonical ints (cached until the next insert)."""
        if self._levels_cache is not None:
            return self._levels_cache
        dh = default_hashes(self.depth)
        pad = self._padded_leaf_count()
        padded = self.leaves + [0] * (pad - len(self.leaves))
        leaves_mont = torch.as_tensor(
            FR.to_mont(np.asarray(padded, dtype=object)), device=self.device)
        levels_dev, _ = build_levels(leaves_mont, self.depth)
        levels = [[int(v) for v in FR.from_mont(lvl)] for lvl in levels_dev]
        # extend with the default-hash folds so levels has depth+1 entries
        top = levels[-1][0]
        for j in range(len(levels) - 1, self.depth):
            top = poseidon_hash_ref([top, dh[j]])
            levels.append([top])
        self._levels_cache = levels
        return levels

    def get_root(self) -> int:
        return self._root

    def get_proof(self, index: int) -> list[int]:
        """Sibling list from the leaf level to depth - 1, default-padded."""
        if not 0 <= index < max(1, len(self.leaves)):
            raise IndexError(f"no leaf {index} in a tree of "
                             f"{len(self.leaves)}")
        dh = default_hashes(self.depth)
        levels = self._levels()
        proof = []
        idx = index
        for k in range(self.depth):
            sib = idx ^ 1
            level = levels[k]
            proof.append(level[sib] if sib < len(level) else dh[k])
            idx >>= 1
        return proof

    @staticmethod
    def verify_proof(leaf: int, index: int, proof: list[int], root: int) -> bool:
        cur = leaf
        idx = index
        for sib in proof:
            cur = (poseidon_hash_ref([cur, sib]) if idx % 2 == 0
                   else poseidon_hash_ref([sib, cur]))
            idx >>= 1
        return cur == root
