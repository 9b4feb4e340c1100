"""Leg-parallel G1 MSMs of a Groth16 proof (the port of
``tpu_zkpool/parallel/prove_stages.py``).

A proof's four G1 MSMs (A, B1, H, K) are independent. On a (leg, pt) mesh
each group of slots along ``pt`` takes one leg, its points sharded over the
group: every slot runs the grid pipeline to its window sums, each group
folds them onto its first slot through K4 and combines them with K6, and
the four leg results are gathered onto the mesh's first slot.
"""

from __future__ import annotations

import torch

from tpu_zkpool_torch.msm import kernels
from tpu_zkpool_torch.msm.grid import SCALAR_BITS, TILE_N
from tpu_zkpool_torch.parallel.msm_sharded import (check_points,
                                                   shard_window_sums)

N_G1_LEGS = 4   # A, B1, H, K


def _leg(piece):
    return None if piece is None else piece[0]


@torch.inference_mode()
def msm_legs_sharded(rows_legs, limbs_legs, mesh, axis_leg: str = "leg",
                     axis_pt: str = "pt", c: int = 13, lanes: int = TILE_N,
                     nbits: int = SCALAR_BITS):
    """Four G1 MSMs, one per group of ``mesh[axis_pt]`` slots.

    rows_legs: int64[4, N, 3, 1, 16] Jacobian Montgomery (legs padded to a
    common N with identities, Z = 0); limbs_legs: int64[4, N, 16] plain
    scalars. N must be a multiple of ``lanes * mesh.shape[axis_pt]``.
    Returns int64[4, 3, 1, 16], the A, B1, H, K results, on the rows'
    device."""
    if rows_legs.shape[0] != N_G1_LEGS or mesh.shape[axis_leg] != N_G1_LEGS:
        raise ValueError(f"want {N_G1_LEGS} legs on a {N_G1_LEGS}-slot "
                         f"'{axis_leg}' axis, got {rows_legs.shape[0]} and "
                         f"{mesh.shape[axis_leg]}")
    check_points(rows_legs.shape[1], mesh.shape[axis_pt], lanes)
    spec = (axis_leg, axis_pt)
    S = shard_window_sums(mesh, [_leg(r) for r in mesh.shard(rows_legs, spec)],
                          [_leg(l) for l in mesh.shard(limbs_legs, spec)], c,
                          lanes, nbits)
    legs = []
    for s, acc in zip(mesh.slots, mesh.fold(mesh.all_gather(S, axis_pt),
                                            kernels.addn)):
        with s.on():
            legs.append(None if acc is None else kernels.horner(acc, c))
    return mesh.join(mesh.all_gather(legs, axis_leg)[0], rows_legs.device)
