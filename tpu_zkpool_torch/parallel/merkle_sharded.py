"""The data-parallel Merkle root: a subtree per slot, then one combine.

The port of the Poseidon stage of ``__graft_entry__.dryrun_multichip``:
the leaves are split over ``mesh[axis]``, each slot builds its subtree on
its own stream (one K7 launch a level), the D subtree roots are gathered
onto the first slot, and the top log2(D) levels hash them pairwise there,
then fold in the default hashes up to ``depth``. The root equals
``merkle.build_levels`` over all the leaves on one device. Where the axis
crosses processes each process builds its own slots' subtrees, the roots
cross through the mesh's gather, and every process returns the root.
"""

from __future__ import annotations

import torch

from tpu_zkpool_torch.hash import poseidon
from tpu_zkpool_torch.merkle.tree import TREE_DEPTH, _default_mont, build_levels


def root_sharded(leaves, mesh, axis="dp", depth: int = TREE_DEPTH):
    """Root of the depth-``depth`` tree over int64[N, 16] Montgomery leaves
    (N a power of two <= 2^depth, at least one leaf a slot; whole in every
    process), on the leaves' device. ``axis``: one name or several taken
    row-major."""
    n, D = leaves.shape[0], mesh.extent(axis)
    if n < D or n & (n - 1) or D & (D - 1) or n > 1 << depth:
        raise ValueError(f"{n} leaves over {D} shards: want powers of two, "
                         f"n >= D and n <= 2^{depth}")
    for dev in mesh.local_devices:
        poseidon.tables(3, dev)      # round constants, on the caller's stream
    sub_depth = (n // D).bit_length() - 1
    roots = []
    for s, part in zip(mesh.slots, mesh.shard(leaves, (axis,))):
        if not s.local:
            roots.append(None)
            continue
        with s.on():
            roots.append(build_levels(part, sub_depth)[1])
    gathered = mesh.all_gather(roots, axis)[0]
    root, top = mesh.slots[0], None
    if root.local:
        with root.on():
            _, top = build_levels(gathered, D.bit_length() - 1)
            if n < 1 << depth:
                dmont = torch.as_tensor(_default_mont(depth),
                                        device=root.device)
                for j in range(n.bit_length() - 1, depth):
                    top = poseidon.hash2(top, dmont[j])
    return mesh.join(top, leaves.device)
