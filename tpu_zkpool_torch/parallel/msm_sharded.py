"""Point-axis-sharded grid MSM over a ``Mesh`` (the port of
``tpu_zkpool/parallel/msm_sharded.py``).

Each slot runs the grid pipeline (``msm.grid.window_sums``: kernels K1-K5)
on its point shard down to W window sums, on its own stream. The sums of
every slot are gathered onto the first slot (W points a slot cross the
mesh, the only exchange) and folded there through K4 (``kernels.addn``) in
mesh order, from zeros, as JAX's ``lax.scan`` does; the Horner combine (K6)
runs once on the folded sums.

On a mesh over several processes (``multihost.pod_mesh``) each process
runs its own slots' window sums; the gather crosses processes where the
axis does (on a (host, chip) mesh one partial a process: W = 20 window
sums of (3, 1, 16) int64), the Horner runs on the root slot in its
process, and the point is returned in every process.
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
    computed on its slot's stream (None at another process's slot)."""
    for dev in mesh.local_devices:
        FP.ones_mont((), dev)        # field constants, on the caller's stream
    out = []
    for s, r, l in zip(mesh.slots, rows_s, limbs_s):
        if not s.local:
            out.append(None)
            continue
        with s.on():
            out.append(window_sums(r, l, c, lanes, nbits=nbits))
    return out


def _combine(mesh, total, c, device):
    """K6's Horner over the folded sums on the root slot (in its process),
    the point returned on ``device`` in every process."""
    root = mesh.slots[0]
    out = None
    if root.local:
        with root.on():
            out = kernels.horner(total, c)
    return mesh.join(out, device)


@torch.inference_mode()
def msm_grid_sharded(rows, scalar_limbs, mesh, axis="dp", c: int = 13,
                     lanes: int = TILE_N, nbits: int = SCALAR_BITS):
    """MSM with the point axis sharded over ``mesh[axis]`` (one axis name,
    or several taken row-major, as ``("host", "chip")`` on a pod mesh).

    rows: int64[N, 3, ncomp, 16] Jacobian Montgomery (Z in {R, 0});
    scalar_limbs: int64[N, 16] plain, whole in every process. N must be a
    multiple of ``lanes`` times the axis's extent. Returns one point row
    (3, ncomp, 16) on the rows' device."""
    check_points(rows.shape[0], mesh.extent(axis), lanes)
    S = shard_window_sums(mesh, mesh.shard(rows, (axis,)),
                          mesh.shard(scalar_limbs, (axis,)), c, lanes, nbits)
    total = mesh.fold(mesh.all_gather(S, axis), kernels.addn)
    return _combine(mesh, total[0], c, rows.device)


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
    return _combine(mesh, total, c, rows.device)
