"""Coefficient-axis-sharded negacyclic NTT over a ``Mesh`` (the port of
``tpu_zkpool/parallel/ntt_sharded.py``).

The ring axis of size n is cut into D = mesh.shape[axis] shards of S = n/D
coefficients. A DIF stage with half-block h pairs i with i + h; while
h >= S the partner lives on slot d ^ (h / S), so the first log2(D) forward
stages (h = n/2 .. S) exchange shards and combine through kernel K9; the
rest are local stages over the shard, as torch ops. The inverse (DIT) runs
its local stages first and its log2(D) exchanges last (h = S .. n/2), the
v side pre-scaled by its twiddle before the exchange and K9 called with
tw = R mod q. Same tables and orderings as ``rlwe/ntt.py``, so the result
equals the single-device transform value for value; the spectrum stays
sharded through ``negacyclic_mul_sharded``.

``exchange``: ``"ppermute"`` moves each whole shard (``Mesh.ppermute``) and
launches K9 once per slot and stage; ``"rdma"`` runs the chunked,
overlapped schedule of ``ntt_rdma.exchange_butterfly`` (chunks of
``ntt_rdma.CHUNK_ROWS`` rows). On CUDA slots both
reach K9; the plain twin runs only on CPU slots.
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
    one = torch.full((n // D,), rlweq.R_MOD_Q, dtype=rlweq.DTYPE,
                     device=device)
    return (rlweq.from_numpy_u32(twist, device),
            rlweq.from_numpy_u32(untwist, device), fwd, inv, one)


class _Shards:
    """One transform's per-slot state: each slot's coordinate d along the
    axis and its device tables, loaded on the caller's stream before the
    mesh copies any shard."""

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
        self.n_cross = (D - 1).bit_length()        # stages with h >= S
        self.d = [mesh.coord(s, axis) for s in mesh.slots]
        self.tabs = [_device_slices(n, D, s.device) for s in mesh.slots]

    def each(self, fn, *per_slot):
        """[fn(slot index, *values)] over the slots, each on its slot's
        compute stream."""
        out = []
        for s, *vals in zip(self.mesh.slots, *per_slot):
            with s.on():
                out.append(fn(s.index, *vals))
        return out

    def tw(self, i, table, hd):
        """Slot i's slice of a cross stage's twiddles: w^(step((d mod hd)S
        + j)), j < S."""
        base = (self.d[i] % hd) * self.S
        return table[base:base + self.S]

    def cross(self, ys, hd, tws, u_sides):
        """One exchange stage with partner d ^ hd through K9."""
        mesh = self.mesh
        partners = [mesh.partner(s, self.axis, hd).index for s in mesh.slots]
        flat = [y.reshape(-1, self.S) for y in ys]
        if self.exchange == "rdma":
            outs = ntt_rdma.exchange_butterfly(mesh, flat, tws, u_sides,
                                               partners)
        else:
            others = mesh.ppermute(flat, partners)
            outs = self.each(lambda i, y, o: ntt_rdma.butterfly(
                y, o, tws[i], u_sides[i]), flat, others)
        return [o.reshape(y.shape) for o, y in zip(outs, ys)]

    def forward(self, xs):
        ys = self.each(lambda i, x: rlweq.mont_mul(
            x, self.tabs[i][0][self.d[i]]), xs)
        for st in range(self.n_cross):             # h = n/2 .. S
            hd = (self.n >> (st + 1)) // self.S
            ys = self.cross(ys, hd, [self.tw(i, t[2][st], hd)
                                     for i, t in enumerate(self.tabs)],
                            [(d // hd) % 2 == 0 for d in self.d])
        for st in range(self.n_cross, len(self.tabs[0][2])):   # h < S
            ys = self.each(lambda i, y: ntt.dif_stage(y, self.tabs[i][2][st]),
                           ys)
        return ys

    def inverse(self, ys):
        n_stages = len(self.tabs[0][3])
        n_local = n_stages - self.n_cross
        xs = ys
        for st in range(n_local):                  # h = 1 .. S/2
            xs = self.each(lambda i, x: ntt.dit_stage(x, self.tabs[i][3][st]),
                           xs)
        for st in range(n_local, n_stages):        # h = S .. n/2
            hd = (1 << st) // self.S
            u = [(d // hd) % 2 == 0 for d in self.d]
            # the v side scales its shard by the twiddle before the exchange
            xs = self.each(lambda i, x: x if u[i] else rlweq.mont_mul(
                x, self.tw(i, self.tabs[i][3][st], hd)), xs)
            xs = self.cross(xs, hd, [t[4] for t in self.tabs], u)
        return self.each(lambda i, x: rlweq.mont_mul(
            x, self.tabs[i][1][self.d[i]]), xs)


def _spec(x, axis):
    return (None,) * (x.dim() - 1) + (axis,)


def forward_sharded(x, mesh, axis: str = "sp", exchange: str = "ppermute"):
    """Negacyclic forward NTT of int32[..., n] (< q) with the last axis
    sharded over ``mesh[axis]``: the bit-reversed spectrum, equal to
    ``rlwe.ntt.forward(x)``, returned on x's device."""
    sh = _Shards(mesh, axis, x.shape[-1], exchange)
    ys = sh.forward(mesh.shard(x, _spec(x, axis)))
    return mesh.unshard(ys, axis, x.device)


def inverse_sharded(y, mesh, axis: str = "sp", exchange: str = "ppermute"):
    """Inverse of :func:`forward_sharded`."""
    sh = _Shards(mesh, axis, y.shape[-1], exchange)
    xs = sh.inverse(mesh.shard(y, _spec(y, axis)))
    return mesh.unshard(xs, axis, y.device)


def negacyclic_mul_sharded(a, b, mesh, axis: str = "sp",
                           exchange: str = "ppermute"):
    """Negacyclic product of int32[..., n] polynomials mod q, the
    coefficient axis sharded end to end (2 log2(D) exchange stages forward,
    log2(D) inverse), returned on a's device."""
    sh = _Shards(mesh, axis, a.shape[-1], exchange)
    fa = sh.forward(mesh.shard(a, _spec(a, axis)))
    fb = sh.forward(mesh.shard(b, _spec(b, axis)))
    prod = sh.each(lambda i, x, y: ntt.pointwise(x, y), fa, fb)
    return mesh.unshard(sh.inverse(prod), axis, a.device)
