"""Coefficient-axis-sharded negacyclic NTT over a ``Mesh`` (the port of
``tpu_zkpool/parallel/ntt_sharded.py``).

The ring axis of size n is cut into D = mesh.shape[axis] shards of S = n/D
coefficients. A DIF stage with half-block h pairs i with i + h; while
h >= S the partner lives on slot d ^ (h / S), so the first log2(D) forward
stages (h = n/2 .. S) exchange shards and combine through kernel K9; the
rest are local stages over the shard, as torch ops. The inverse (DIT) runs
its local stages first and its log2(D) exchanges last (h = S .. n/2), K9
in its inverse form scaling the v side by the twiddle itself (JAX scales
it before the exchange). Same tables and orderings as ``rlwe/ntt.py``, so
the result equals the single-device transform value for value; the
spectrum stays sharded through ``negacyclic_mul_sharded``.

``exchange``: ``"ppermute"`` copies each whole shard (``Mesh.ppermute``)
and K9 combines with the copies; ``"rdma"`` has K9 read each partner's
shard itself. Either way a stage is one K9 launch a device
(``ntt_rdma.exchange_butterfly``); the plain twin runs only on CPU slots.

On a CUDA mesh in one process each entry point replays one CUDA graph a
(mesh, axis, exchange, input shape, dtype, device), captured at its first
call (``Mesh.graphed``): the port's counterpart of the JAX package's
jitted ``_fwd_fn``, ``_inv_fn`` and ``_mul_fn``. A CPU mesh runs the same
code eagerly. So does a mesh whose slots span processes (as on JAX's
multi-host mesh, ``axis`` may cross them): a CUDA graph holds one
process's work, so there the eager run is the designed path. Each process
then computes its own slots only, its cross stages exchange with the
other processes (``Mesh.ppermute`` over ``torch.distributed``, or K9
reading the partner's shard by CUDA IPC; ``ntt_rdma``), and the result
comes back whole in every process, as JAX's ``out_specs`` gathers it.
"""

from __future__ import annotations

import functools

import torch

from tpu_zkpool_torch.fields import rlweq
from tpu_zkpool_torch.parallel import ntt_rdma
from tpu_zkpool_torch.rlwe import ntt
from tpu_zkpool_torch.rlwe.ntt import _tables

EXCHANGES = ("ppermute", "rdma")


def _local_slices(n: int, D: int):
    """Per-shard tables: (twist, untwist) as (D, n/D) arrays and the
    forward / inverse stage tables."""
    twist, untwist, fwd, inv = _tables(n)
    S = n // D
    return twist.reshape(D, S), untwist.reshape(D, S), fwd, inv


@functools.lru_cache(maxsize=None)
def _device_slices(n: int, D: int, device: torch.device):
    """``_local_slices(n, D)`` on ``device`` as int32 tensors, with the
    stage tables shared with ``rlwe.ntt.device_tables``."""
    twist, untwist, _, _ = _local_slices(n, D)
    _, _, fwd, inv = ntt.device_tables(n, device)
    return (rlweq.from_numpy_u32(twist, device),
            rlweq.from_numpy_u32(untwist, device), fwd, inv)


class _Shards:
    """One transform's per-slot state: each slot's coordinate d along the
    axis and, at this process's slots, its device tables, loaded (with
    K9's library on a CUDA mesh) on the caller's stream before the mesh
    copies any shard or captures a graph."""

    def __init__(self, mesh, axis, n, exchange):
        D = mesh.shape[axis]
        S = n // D
        if D & (D - 1) or S * D != n or S < 2:
            raise ValueError(f"n = {n} does not split into a power-of-two "
                             f"count of shards of >= 2 coefficients over {D}")
        if exchange not in EXCHANGES:
            raise ValueError(f"exchange must be one of {EXCHANGES}, got "
                             f"{exchange!r}")
        self.mesh, self.axis, self.exchange = mesh, axis, exchange
        self.n, self.D, self.S = n, D, S
        self.n_stages = n.bit_length() - 1
        self.n_cross = (D - 1).bit_length()        # stages with h >= S
        self.d = [mesh.coord(s, axis) for s in mesh.slots]
        self.tabs = [_device_slices(n, D, s.device) if s.local else None
                     for s in mesh.slots]
        if any(s.local and s.device.type == "cuda" for s in mesh.slots):
            ntt_rdma.load()

    def each(self, fn, *per_slot):
        """[fn(slot index, *values)] over this process's slots, each on
        its slot's compute stream (None at another process's slot)."""
        out = []
        for s, *vals in zip(self.mesh.slots, *per_slot):
            if not s.local:
                out.append(None)
                continue
            with s.on():
                out.append(fn(s.index, *vals))
        return out

    def tw(self, i, table, hd):
        """Slot i's slice of a cross stage's twiddles: w^(step((d mod hd)S
        + j)), j < S."""
        base = (self.d[i] % hd) * self.S
        return table[base:base + self.S]

    def cross(self, ys, hd, st, inverse=False):
        """Exchange stage ``st`` (of the forward or the inverse tables)
        with partner d ^ hd through K9, each slot on its slice of the
        stage's twiddles; partners may live in other processes."""
        mesh, k = self.mesh, 3 if inverse else 2
        partners = [mesh.partner(s, self.axis, hd).index for s in mesh.slots]
        flat = [None if y is None else y.reshape(-1, self.S) for y in ys]
        tws = [None if t is None else self.tw(i, t[k][st], hd)
               for i, t in enumerate(self.tabs)]
        outs = ntt_rdma.exchange_butterfly(
            mesh, flat, tws, [(d // hd) % 2 == 0 for d in self.d], partners,
            self.exchange, inverse)
        return [None if o is None else o.reshape(y.shape)
                for o, y in zip(outs, ys)]

    def forward(self, xs):
        ys = self.each(lambda i, x: rlweq.mont_mul(
            x, self.tabs[i][0][self.d[i]]), xs)
        for st in range(self.n_cross):             # h = n/2 .. S
            ys = self.cross(ys, (self.n >> (st + 1)) // self.S, st)
        for st in range(self.n_cross, self.n_stages):          # h < S
            ys = self.each(lambda i, y: ntt.dif_stage(y, self.tabs[i][2][st]),
                           ys)
        return ys

    def inverse(self, ys):
        n_local = self.n_stages - self.n_cross
        xs = ys
        for st in range(n_local):                  # h = 1 .. S/2
            xs = self.each(lambda i, x: ntt.dit_stage(x, self.tabs[i][3][st]),
                           xs)
        for st in range(n_local, self.n_stages):   # h = S .. n/2
            xs = self.cross(xs, (1 << st) // self.S, st, inverse=True)
        return self.each(lambda i, x: rlweq.mont_mul(
            x, self.tabs[i][1][self.d[i]]), xs)

    def unshard(self, ys, device):
        """The whole result on ``device`` in every process, after the last
        cross-process partner reads have settled (``ntt_rdma.settle``)."""
        ntt_rdma.settle(self.mesh)
        return self.mesh.unshard(ys, self.axis, device)


def _spec(x, axis):
    return (None,) * (x.dim() - 1) + (axis,)


def _forward(sh, x):
    return sh.unshard(sh.forward(sh.mesh.shard(x, _spec(x, sh.axis))),
                      x.device)


def _inverse(sh, y):
    return sh.unshard(sh.inverse(sh.mesh.shard(y, _spec(y, sh.axis))),
                      y.device)


def _mul(sh, a, b):
    fa = sh.forward(sh.mesh.shard(a, _spec(a, sh.axis)))
    fb = sh.forward(sh.mesh.shard(b, _spec(b, sh.axis)))
    prod = sh.each(lambda i, x, y: ntt.pointwise(x, y), fa, fb)
    return sh.unshard(sh.inverse(prod), a.device)


def _run(sh, key, fn, *xs):
    """``fn(*xs)``: replayed from ``Mesh.graphed`` in one process, eager on
    a mesh whose slots span processes (the module docstring)."""
    if len(sh.mesh.processes) > 1:
        return fn(*xs)
    return sh.mesh.graphed(key + (sh.axis, sh.exchange), fn, *xs)


def forward_sharded(x, mesh, axis: str = "sp", exchange: str = "ppermute"):
    """Negacyclic forward NTT of int32[..., n] (< q) with the last axis
    sharded over ``mesh[axis]``: the bit-reversed spectrum, equal to
    ``rlwe.ntt.forward(x)``, returned on x's device."""
    sh = _Shards(mesh, axis, x.shape[-1], exchange)
    return _run(sh, ("forward",), lambda t: _forward(sh, t), x)


def inverse_sharded(y, mesh, axis: str = "sp", exchange: str = "ppermute"):
    """Inverse of :func:`forward_sharded`."""
    sh = _Shards(mesh, axis, y.shape[-1], exchange)
    return _run(sh, ("inverse",), lambda t: _inverse(sh, t), y)


def negacyclic_mul_sharded(a, b, mesh, axis: str = "sp",
                           exchange: str = "ppermute"):
    """Negacyclic product of int32[..., n] polynomials mod q, the
    coefficient axis sharded end to end (2 log2(D) exchange stages forward,
    log2(D) inverse), returned on a's device."""
    sh = _Shards(mesh, axis, a.shape[-1], exchange)
    return _run(sh, ("mul",), lambda s, t: _mul(sh, s, t), a, b)
