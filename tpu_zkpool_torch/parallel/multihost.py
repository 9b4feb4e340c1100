"""The (host, chip) mesh layout and the hierarchical fold (the port of
``tpu_zkpool/parallel/multihost.py``'s ``pod_mesh`` and
``hierarchical_fold``).

The port runs one process. ``initialize()`` (``jax.distributed`` startup)
is not ported: a multi-process form (one process per card over NCCL) waits
for a machine with more than one card.
"""

from __future__ import annotations

import torch

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.parallel.mesh import Mesh


def pod_mesh(axis_host: str = "host", axis_chip: str = "chip") -> Mesh:
    """(hosts, cards per host) mesh over this process's CUDA devices: one
    process is one host, so (1, torch.cuda.device_count()). Raises without
    a CUDA device."""
    resolve_device()
    return Mesh([[torch.device("cuda", i)
                  for i in range(torch.cuda.device_count())]],
                (axis_host, axis_chip))


def hierarchical_fold(fold_fn, values, mesh: Mesh, axis_host: str = "host",
                      axis_chip: str = "chip"):
    """Two-level reduction of per-slot partials (``values``, slot order):
    ``fold_fn(acc, part) -> acc`` combines them. Level 1 gathers each
    host's chips onto its first chip and folds from zeros; level 2 gathers
    those partials onto the mesh's first slot and folds again, so one
    partial per host crosses the host axis. Returns the result, on the
    first slot's stream."""
    per_host = mesh.fold(mesh.all_gather(values, axis_chip), fold_fn)
    return mesh.fold(mesh.all_gather(per_host, axis_host), fold_fn)[0]
