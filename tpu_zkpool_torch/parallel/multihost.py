"""Multi-process startup, the (host, chip) mesh and the hierarchical fold
(the port of ``tpu_zkpool/parallel/multihost.py``).

- ``initialize()``: ``torch.distributed`` startup from explicit arguments
  or the environment torch's launcher sets (``MASTER_ADDR``,
  ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``);
  ``process_index()`` and ``process_count()``.
- ``pod_mesh()``: a (process_count, chips per process) mesh whose host axis
  is the process boundary (``Mesh(..., processes=)``), so the chip axis
  stays within a process and only the host axis crosses.
- ``span_mesh()``: the same slots as one axis over every process (each
  process owns a run of consecutive slots), as the sharded NTT takes it.
- ``hierarchical_fold()``: fold over the chip axis first, then one partial
  a host over the host axis.

One process with no runtime is JAX's single-host case: ``initialize()``
returns False and the same code runs unchanged.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.parallel.mesh import Mesh

LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               timeout: datetime.timedelta | None = None) -> bool:
    """Start the ``torch.distributed`` runtime: from ``coordinator``
    ("host:port"), ``num_processes`` and ``process_id`` when given, else
    from the launcher's environment (``LAUNCHER_ENV``). Returns True when a
    multi-process runtime started, False only when neither the arguments
    nor that environment are present (one process, no runtime).

    ``backend``: ``"nccl"`` or ``"gloo"``; None means NCCL where CUDA is
    available (after ``torch.cuda.set_device(LOCAL_RANK)``) and Gloo on
    the CPU. Processes that share one card name Gloo: NCCL refuses two
    ranks on one card. ``timeout`` bounds the rendezvous and each
    collective (torch's default when None).

    Departure from JAX: the JAX package swallows a failed start (``except
    Exception: pass``) and returns False; the port raises, so a process
    never runs alone when its peers expect it.
    """
    if coordinator is None:
        present = [k for k in LAUNCHER_ENV if k in os.environ]
        if not present:
            return False
        if len(present) < len(LAUNCHER_ENV):
            raise ValueError(f"the launcher's environment is partial: "
                             f"{present} set, {LAUNCHER_ENV} needed")
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank(process_id))
    kw = {} if timeout is None else dict(timeout=timeout)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)
    return True


def process_index() -> int:
    """This process's rank (0 without a runtime)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    """The number of processes (1 without a runtime)."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def local_rank(rank: int | None = None) -> int:
    """This process's card on its host: ``LOCAL_RANK`` where the launcher
    set it, else the rank (processes started by hand on one host)."""
    return int(os.environ.get("LOCAL_RANK",
                              process_index() if rank is None else rank))


def pod_mesh(axis_host: str = "host", axis_chip: str = "chip", device=None,
             chips: int | None = None) -> Mesh:
    """(process_count, chips per process) mesh over every process; each
    process owns row ``process_index()``.

    ``device=None``: one process keeps the single-host layout, every card
    of this machine (1, torch.cuda.device_count()); in a multi-process run
    each process takes one slot on ``cuda:LOCAL_RANK`` and raises if that
    card does not exist (ranks are never wrapped onto one card). ``device``
    and ``chips`` give each process ``chips`` (default 1) virtual slots on
    the named device: the CPU in the tests, or one card shared on purpose.
    Every process must pass the same ``chips``."""
    return _process_mesh(device, chips, (axis_host, axis_chip))


def span_mesh(axis: str = "sp", device=None, chips: int | None = None) -> Mesh:
    """``pod_mesh``'s slots as one axis over every process, in process
    order (slot i in process i // chips): the axis crosses the processes
    wherever a stage pairs slots of two of them. ``device`` and ``chips``
    as for ``pod_mesh``."""
    return _process_mesh(device, chips, (axis,))


def _process_mesh(device, chips, axis_names) -> Mesh:
    """``pod_mesh``'s (processes, chips) grid, this process's row named
    and the others' None, under two axis names or flattened under one;
    raises where the processes' chip counts differ."""
    P, rank = process_count(), process_index()
    if device is None and P == 1 and chips is None:
        resolve_device()
        row = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    else:
        if device is None:
            resolve_device()
            device = torch.device("cuda", local_rank())
        row = [resolve_device(device)] * (1 if chips is None else chips)
    grid = np.empty((P, len(row)), dtype=object)
    grid[rank] = row
    owner = np.repeat(np.arange(P)[:, None], len(row), 1)
    if len(axis_names) == 1:
        grid, owner = grid.reshape(-1), owner.reshape(-1)
    mesh = Mesh(grid, axis_names, processes=owner)
    if P > 1:
        counts = [None] * P
        dist.all_gather_object(counts, len(row))
        if len(set(counts)) > 1:
            raise ValueError(f"processes pass different chip counts: "
                             f"{counts}")
    return mesh


def hierarchical_fold(fold_fn, values, mesh: Mesh, axis_host: str = "host",
                      axis_chip: str = "chip"):
    """Two-level reduction of per-slot partials (``values``, slot order):
    ``fold_fn(acc, part) -> acc`` combines them. Level 1 gathers each
    host's chips onto its first chip and folds from zeros; level 2 gathers
    those partials onto the mesh's first slot and folds again, so one
    partial per host crosses the host axis (between processes on a pod
    mesh). Returns the result on the first slot's stream, in that slot's
    process (None in the others; ``mesh.join`` hands it to all)."""
    per_host = mesh.fold(mesh.all_gather(values, axis_chip), fold_fn)
    return mesh.fold(mesh.all_gather(per_host, axis_host), fold_fn)[0]
