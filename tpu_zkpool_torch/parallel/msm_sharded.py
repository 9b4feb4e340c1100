"""Point-axis-sharded grid MSM over a ``Mesh`` (the port of
``tpu_zkpool/parallel/msm_sharded.py``).

Each slot runs the grid pipeline (``msm.grid.window_sums``: kernels K1-K5)
on its point shard down to W window sums, on its own stream. The sums of
every slot are gathered onto the first slot (W points a slot cross the
mesh, the only exchange) and folded there through K4 (``kernels.addn``) in
mesh order, from zeros, as JAX's ``lax.scan`` does; the Horner combine (K6)
runs once on the folded sums.
"""

from __future__ import annotations

import torch

from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.msm import kernels
from tpu_zkpool_torch.msm.grid import SCALAR_BITS, TILE_N, window_sums
from tpu_zkpool_torch.parallel.multihost import hierarchical_fold


def check_points(n_points, D, lanes):
    """Raise unless every one of D shards gets a multiple of ``lanes``."""
    if n_points % (lanes * D):
        raise ValueError(f"{n_points} points over {D} shards: need a multiple "
                         f"of {lanes} points (the lanes) per shard")


def shard_window_sums(mesh, rows_s, limbs_s, c, lanes, nbits):
    """Per slot, the window sums (W, 3, ncomp, 16) of its shard, each
    computed on its slot's stream."""
    for dev in {s.device for s in mesh.slots}:
        FP.ones_mont((), dev)        # field constants, on the caller's stream
    out = []
    for s, r, l in zip(mesh.slots, rows_s, limbs_s):
        with s.on():
            out.append(window_sums(r, l, c, lanes, nbits=nbits))
    return out


@torch.inference_mode()
def msm_grid_sharded(rows, scalar_limbs, mesh, axis: str = "dp", c: int = 13,
                     lanes: int = TILE_N, nbits: int = SCALAR_BITS):
    """MSM with the point axis sharded over ``mesh[axis]``.

    rows: int64[N, 3, ncomp, 16] Jacobian Montgomery (Z in {R, 0});
    scalar_limbs: int64[N, 16] plain. N must be a multiple of
    ``lanes * mesh.shape[axis]``. Returns one point row (3, ncomp, 16) on
    the rows' device."""
    check_points(rows.shape[0], mesh.shape[axis], lanes)
    S = shard_window_sums(mesh, mesh.shard(rows, (axis,)),
                          mesh.shard(scalar_limbs, (axis,)), c, lanes, nbits)
    total = mesh.fold(mesh.all_gather(S, axis), kernels.addn)
    root = mesh.slots[0]
    with root.on():
        out = kernels.horner(total[0], c)
    return mesh.join(out, rows.device)


@torch.inference_mode()
def msm_grid_sharded_2d(rows, scalar_limbs, mesh, axis_host: str = "host",
                        axis_chip: str = "chip", c: int = 13,
                        lanes: int = TILE_N, nbits: int = SCALAR_BITS):
    """MSM over a (host, chip) mesh: the per-slot window sums fold over the
    chip axis first, then one partial per host over the host axis
    (``multihost.hierarchical_fold``), before the one Horner combine."""
    check_points(rows.shape[0], mesh.shape[axis_host] * mesh.shape[axis_chip],
                 lanes)
    spec = ((axis_host, axis_chip),)
    S = shard_window_sums(mesh, mesh.shard(rows, spec),
                          mesh.shard(scalar_limbs, spec), c, lanes, nbits)
    total = hierarchical_fold(kernels.addn, S, mesh, axis_host, axis_chip)
    root = mesh.slots[0]
    with root.on():
        out = kernels.horner(total, c)
    return mesh.join(out, rows.device)
