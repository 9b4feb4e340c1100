"""A single-process device mesh: the port's stand-in for ``jax.sharding.Mesh``,
``shard_map`` and the collectives ``all_gather`` and ``ppermute``.

A ``Mesh`` names the axes of a grid of shard slots. Each slot has a
``torch.device`` and, on CUDA, its own compute stream and copy stream, so
the work of different slots may overlap on the card. One Python process
enqueues every slot's work in turn, as JAX's single controller traces one
program for every device under ``jit``.

- ``Mesh(devices, axis_names)``: the caller names every slot's device.
  A mesh that asks for a card that does not exist raises.
- ``Mesh.virtual(shape, axis_names, device=None)``: every slot on one
  device (``cuda`` unless the caller passes another). On one card this is
  how the sharded paths run; on the CPU it is how the tests run them.

Ordering follows the caching allocator's rules. A copy onto a slot runs on
that slot's copy stream after an event of the stream that wrote its source,
the slot's compute stream waits on an event recorded after the copy, and
every tensor used on a stream it was not allocated on is marked with
``Tensor.record_stream`` so its memory is not handed out early. A result
goes back to the caller (``join``, ``unshard``) only after the caller's
current stream has waited on every slot's compute stream. On CPU slots there
are no streams and all of it runs in order.

Copies between distinct cards (peer copies) take the same code path; they
run only where the machine has more than one card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device


def record(stream):
    """An event recorded on ``stream`` now (None for a CPU slot's None)."""
    return None if stream is None else stream.record_event()


def wait(stream, event):
    """Make ``stream`` wait on ``event``; no-op on the CPU."""
    if stream is not None and event is not None:
        stream.wait_event(event)


def keep(t, stream):
    """Mark CUDA tensor ``t`` as used on ``stream`` (``record_stream``)."""
    if stream is not None and t.is_cuda:
        t.record_stream(stream)


class Slot:
    """One shard position: ``index`` (row-major over the mesh), ``coords``,
    ``device``, and on CUDA ``stream`` (compute) and ``copy_stream``."""

    def __init__(self, index: int, coords: tuple, device: torch.device):
        self.index, self.coords, self.device = index, coords, device
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
            self.copy_stream = torch.cuda.Stream(device)
        else:
            self.stream = self.copy_stream = None

    @contextlib.contextmanager
    def on(self, copy: bool = False):
        """Work enqueued inside runs on this slot's device and its compute
        stream (its copy stream with ``copy=True``)."""
        stream = self.copy_stream if copy else self.stream
        if stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            yield


def _cuda_index(dev: torch.device) -> torch.device:
    if dev.type != "cuda":
        return dev
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"the mesh asks for cuda:{index}, but this machine "
                         f"has {torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


class Mesh:
    """Named axes over a grid of shard slots (see the module docstring)."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs as many "
                             f"axis names, got {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        self.slots = [Slot(i, c, _cuda_index(resolve_device(grid[c])))
                      for i, c in enumerate(np.ndindex(grid.shape))]

        self._graphs = {}

    @classmethod
    def virtual(cls, shape, axis_names, device=None):
        """Every slot of a ``shape`` grid on one device (``cuda`` unless
        ``device`` names another): D virtual shards on one card."""
        grid = np.empty(tuple(shape), dtype=object)
        grid.fill(resolve_device(device))
        return cls(grid, axis_names)

    @property
    def size(self) -> int:
        return len(self.slots)

    def coord(self, slot: Slot, axis: str) -> int:
        return slot.coords[self.axis_names.index(axis)]

    def _at(self, coords) -> Slot:
        return self.slots[int(np.ravel_multi_index(
            coords, tuple(self.shape.values())))]

    def partner(self, slot: Slot, axis: str, hd: int) -> Slot:
        """The slot whose coordinate along ``axis`` is slot's XOR ``hd``."""
        c = list(slot.coords)
        c[self.axis_names.index(axis)] ^= hd
        return self._at(c)

    def group(self, slot: Slot, axis: str) -> list:
        """The slots that differ from ``slot`` only along ``axis``, in
        order along it."""
        k = self.axis_names.index(axis)
        return [self._at(slot.coords[:k] + (i,) + slot.coords[k + 1:])
                for i in range(self.shape[axis])]

    def ready(self) -> list:
        """Per slot, an event after the work queued on its compute stream
        so far (None on the CPU)."""
        return [record(s.stream) for s in self.slots]

    # -------------------------------------------------------- in and out

    def shard(self, x: torch.Tensor, spec) -> list:
        """Cut ``x`` for every slot, in slot order: dim i is split evenly
        over the axes ``spec[i]`` names (one name, a tuple of names taken
        row-major, or None for whole); slots that differ only along axes
        the spec leaves out get the same piece. Each piece is copied,
        contiguous, onto its slot after the work already queued on the
        caller's stream."""
        src = torch.cuda.current_stream(x.device) if x.is_cuda else None
        ev = record(src)
        out = []
        for s in self.slots:
            piece = x
            for dim, names in enumerate(spec):
                if names is None:
                    continue
                names = (names,) if isinstance(names, str) else tuple(names)
                k, idx = 1, 0
                for a in names:
                    k *= self.shape[a]
                    idx = idx * self.shape[a] + self.coord(s, a)
                if piece.shape[dim] % k:
                    raise ValueError(f"dim {dim} of size {piece.shape[dim]} "
                                     f"does not split over {names} ({k})")
                size = piece.shape[dim] // k
                piece = piece.narrow(dim, idx * size, size)
            wait(s.copy_stream, ev)
            with s.on(copy=True):
                dst = torch.empty(piece.shape, dtype=piece.dtype,
                                  device=s.device)
                dst.copy_(piece, non_blocking=True)
            keep(piece, s.copy_stream)
            wait(s.stream, record(s.copy_stream))
            keep(dst, s.stream)
            out.append(dst)
        return out

    def _sync_to(self, device: torch.device):
        """Order the caller's current stream on ``device`` after every
        slot's compute stream (on the CPU: wait for them); returns that
        stream (None on the CPU)."""
        if device.type == "cuda":
            cs = torch.cuda.current_stream(device)
            for s in self.slots:
                wait(cs, record(s.stream))
            return cs
        for s in self.slots:
            if s.stream is not None:
                s.stream.synchronize()
        return None

    def join(self, t: torch.Tensor, device) -> torch.Tensor:
        """A result computed on a slot, for the caller on ``device``."""
        device = torch.device(device)
        keep(t, self._sync_to(device))
        return t.to(device)

    def unshard(self, pieces: list, axis: str, device):
        """Concatenate back along the last dim the pieces of the slots along
        ``axis`` through slot 0, on ``device`` for the caller."""
        device = torch.device(device)
        cs = self._sync_to(device)
        parts = []
        for s in self.group(self.slots[0], axis):
            keep(pieces[s.index], cs)
            parts.append(pieces[s.index].to(device))
        return torch.cat(parts, -1)

    def graphed(self, key, fn, *xs) -> torch.Tensor:
        """``fn(*xs)`` (tensors in, one tensor out), replayed from a CUDA
        graph: the port's ``jax.jit`` of a whole sharded program.

        On a CUDA mesh the first call for (``key``, each x's shape, dtype
        and device) captures ``fn`` on static copies of the inputs on slot
        0's device, with every slot stream it forks into; every call copies
        its inputs in (outside the graph, so an input on another device
        moves first), replays, and returns a clone of the output on
        ``xs[0]``'s device. What ``fn`` loads from the host (tables,
        libraries) must be loaded before the first call: a capture cannot
        copy from the host, and a failed capture raises. Launch counters
        count at capture, not at replay. On a CPU mesh ``fn`` runs eagerly.
        A mesh over several cards captures on slot 0's card with the
        others' streams forked into it; that needs more than one card and
        has not run.
        """
        dev = self.slots[0].device
        if dev.type != "cuda":
            return fn(*xs)
        key = (key,) + tuple((tuple(x.shape), x.dtype, x.device) for x in xs)
        if key not in self._graphs:
            static = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                      for x in xs]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(dev):
                stream = torch.cuda.Stream(dev)
                with torch.cuda.graph(graph, stream=stream):
                    out = fn(*static)
            self._graphs[key] = graph, static, out
        graph, static, out = self._graphs[key]
        with torch.cuda.device(dev):
            for s, x in zip(static, xs):
                s.copy_(x)
            graph.replay()
            res = out.clone()
        return res.to(xs[0].device)

    # ------------------------------------------------------ collectives

    def _collect(self, dst: Slot, pairs, ready) -> torch.Tensor:
        """Copy each (source slot, tensor) onto ``dst``, stacked on a new
        leading axis, on dst's copy stream after each source's event."""
        for src, _ in pairs:
            wait(dst.copy_stream, ready[src.index])
        first = pairs[0][1]
        with dst.on(copy=True):
            buf = torch.empty((len(pairs),) + tuple(first.shape),
                              dtype=first.dtype, device=dst.device)
            for i, (_, t) in enumerate(pairs):
                buf[i].copy_(t, non_blocking=True)
                keep(t, dst.copy_stream)
        wait(dst.stream, record(dst.copy_stream))
        keep(buf, dst.stream)
        return buf

    def all_gather(self, values: list, axis: str) -> list:
        """Per slot (slot order), the values of its group along ``axis``
        stacked (mesh.shape[axis], ...) on the group's first slot, None
        elsewhere. ``values`` holds a tensor or None per slot; a group with
        a value on its first slot must have one on every slot."""
        ready = self.ready()
        out = [None] * self.size
        for s in self.slots:
            if self.coord(s, axis) or values[s.index] is None:
                continue
            out[s.index] = self._collect(
                s, [(m, values[m.index]) for m in self.group(s, axis)], ready)
        return out

    def ppermute(self, values: list, partners: list) -> list:
        """Per slot s, a copy onto s of ``values[partners[s]]`` (partners
        as slot indices): a whole-shard pairwise exchange."""
        ready = self.ready()
        return [self._collect(s, [(self.slots[p], values[p])], ready)[0]
                for s, p in zip(self.slots, partners)]

    def fold(self, stacks: list, fold_fn) -> list:
        """On each slot holding a stack (from ``all_gather``), fold its rows
        in order from zeros, ``acc = fold_fn(acc, row)``, on that slot's
        stream: the port of ``lax.scan`` over a gathered axis."""
        out = [None] * self.size
        for s, st in zip(self.slots, stacks):
            if st is None:
                continue
            with s.on():
                acc = torch.zeros_like(st[0])
                for part in st:
                    acc = fold_fn(acc, part)
            out[s.index] = acc
        return out
