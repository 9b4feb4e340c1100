"""A device mesh: the port's stand-in for ``jax.sharding.Mesh``,
``shard_map`` and the collectives ``all_gather`` and ``ppermute``.

A ``Mesh`` names the axes of a grid of shard slots. Each slot has a
``torch.device`` and, on CUDA, its own compute stream and copy stream, so
the work of different slots may overlap on the card. One Python process
enqueues its slots' work in turn, as JAX's controller traces one program
for its devices under ``jit``.

- ``Mesh(devices, axis_names)``: the caller names every slot's device.
  A mesh that asks for a card that does not exist raises.
- ``Mesh.virtual(shape, axis_names, device=None)``: every slot on one
  device (``cuda`` unless the caller passes another). On one card this is
  how the sharded paths run; on the CPU it is how the tests run them.
- ``Mesh(devices, axis_names, processes=grid)``: slots owned by the
  processes of a ``torch.distributed`` runtime (``multihost.initialize``;
  ``multihost.pod_mesh`` builds the (host, chip) form). Every process
  builds the same mesh and runs the same collectives in the same order;
  only its own slots hold a device and streams, like JAX's addressable
  devices, and ``devices`` is read at those slots only. ``shard`` cuts
  pieces for this process's slots from an input that is whole in every
  process; ``all_gather`` over a group that spans processes exchanges its
  other members through ``torch.distributed.all_gather`` on a process
  subgroup (one a set of processes, made at the mesh's first use of it);
  ``join`` and ``unshard`` return the result in every process, broadcast
  from the root slot's process. ``ppermute`` sends the values whose
  partner lives in another process through ``torch.distributed`` point to
  point, one stack a peer process (``routes``, ``swap``). K9's partner
  read across processes maps the partner's shard by CUDA IPC
  (``ntt_rdma``). ``graphed`` has no cross-process form: a CUDA graph
  holds one process's work, so on an axis that crosses processes it
  raises.

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

A cross-process gather or ppermute over Gloo, the backend for CPU tensors
and for processes that share one card, moves host memory: a CUDA value is
copied to the host, exchanged and copied back to the card on purpose, in
``_exchange`` and ``ppermute``. That is staging, not a fallback; the work
on either side stays on the card. Over NCCL the values stay on the card
(that form needs distinct cards and has not run).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

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


def _names(axis) -> tuple:
    """An axis argument as a tuple of names: one name, or several taken
    row-major as one flattened axis."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Slot:
    """One shard position: ``index`` (row-major over the mesh), ``coords``,
    the ``process`` that owns it, ``local`` (owned by this process), and for
    a local slot ``device`` and on CUDA ``stream`` (compute) and
    ``copy_stream``; another process's slot has ``device`` None and no
    streams."""

    def __init__(self, index: int, coords: tuple, device, process: int,
                 local: bool):
        self.index, self.coords, self.device = index, coords, device
        self.process, self.local = process, local
        if device is not None and device.type == "cuda":
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

    def __init__(self, devices, axis_names, processes=None):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs as many "
                             f"axis names, got {axis_names}")
        rank = _rank()
        owner = (np.full(grid.shape, rank) if processes is None
                 else np.asarray(processes, dtype=np.int64))
        if owner.shape != grid.shape:
            raise ValueError(f"processes {owner.shape} must have the device "
                             f"grid's shape {grid.shape}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, grid.shape))
        self.slots = []
        for i, c in enumerate(np.ndindex(grid.shape)):
            p = int(owner[c])
            dev = _cuda_index(resolve_device(grid[c])) if p == rank else None
            self.slots.append(Slot(i, c, dev, p, p == rank))
        self.processes = sorted({s.process for s in self.slots})

        self._graphs = {}
        self._groups = {}

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

    @property
    def local_devices(self) -> set:
        """The devices of this process's slots."""
        return {s.device for s in self.slots if s.local}

    def extent(self, axis) -> int:
        """The size of ``axis`` (one name, or several as one axis)."""
        return int(np.prod([self.shape[a] for a in _names(axis)]))

    def coord(self, slot: Slot, axis) -> int:
        """slot's coordinate along ``axis`` (several names: row-major)."""
        idx = 0
        for a in _names(axis):
            idx = idx * self.shape[a] + slot.coords[self.axis_names.index(a)]
        return idx

    def _at(self, coords) -> Slot:
        return self.slots[int(np.ravel_multi_index(
            coords, tuple(self.shape.values())))]

    def partner(self, slot: Slot, axis: str, hd: int) -> Slot:
        """The slot whose coordinate along ``axis`` is slot's XOR ``hd``."""
        c = list(slot.coords)
        c[self.axis_names.index(axis)] ^= hd
        return self._at(c)

    def group(self, slot: Slot, axis) -> list:
        """The slots that differ from ``slot`` only along ``axis``, in
        order along it."""
        names = _names(axis)
        ks = [self.axis_names.index(a) for a in names]
        out = []
        for sub in np.ndindex(tuple(self.shape[a] for a in names)):
            c = list(slot.coords)
            for k, v in zip(ks, sub):
                c[k] = v
            out.append(self._at(c))
        return out

    def crossing(self, axis) -> bool:
        """Whether a group along ``axis`` spans more than one process."""
        return any(len({m.process for m in self.group(s, axis)}) > 1
                   for s in self.slots)

    def require_local(self, axis, what: str):
        """Raise ``ValueError`` if ``axis`` crosses processes: ``what`` has
        no cross-process form."""
        if self.crossing(axis):
            raise ValueError(f"{what} over axis {axis!r}: the axis crosses "
                             f"processes, and {what} has no cross-process "
                             f"form (it needs one process's slots)")

    def routes(self, partners: list) -> dict:
        """The cross-process part of a pairwise exchange in which slot t
        takes the value of slot ``partners[t]``: per peer process, in
        rank order, (the local slots whose values it takes, the local
        slots that take a value from it), each list in the order of the
        taking slot. Every process derives the same lists from the same
        ``partners``, so what one sends the other expects in that order."""
        out = {}
        for t in self.slots:
            p = self.slots[partners[t.index]]
            if p.process == t.process:
                continue
            if p.local:
                out.setdefault(t.process, ([], []))[0].append(p.index)
            elif t.local:
                out.setdefault(p.process, ([], []))[1].append(t.index)
        return dict(sorted(out.items()))

    def swap(self, peers: dict):
        """Point-to-point with each peer process: ``peers`` maps a rank to
        (tensor to send or None, tensor to receive into or None). Every
        send and receive is posted (``dist.isend`` / ``irecv``, the peers
        in rank order in every process) before any is waited on, so two
        processes that swap with each other cannot deadlock. A pair needs
        no process group of its own: point to point runs on the world's."""
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a mesh whose slots span processes exchanges "
                               "through torch.distributed: start it first "
                               "(multihost.initialize)")
        works = []
        for q, (send, recv) in sorted(peers.items()):
            if send is not None:
                works.append(dist.isend(send.contiguous(), q))
            if recv is not None:
                works.append(dist.irecv(recv, q))
        for w in works:
            w.wait()

    def ready(self) -> list:
        """Per slot, an event after the work queued on its compute stream
        so far (None on the CPU and for another process's slot)."""
        return [record(s.stream) for s in self.slots]

    # -------------------------------------------------------- in and out

    def shard(self, x: torch.Tensor, spec) -> list:
        """Cut ``x`` for this process's slots, in slot order (None at
        another process's slot): dim i is split evenly over the axes
        ``spec[i]`` names (one name, a tuple of names taken row-major, or
        None for whole); slots that differ only along axes the spec leaves
        out get the same piece. Each piece is copied, contiguous, onto its
        slot after the work already queued on the caller's stream."""
        src = torch.cuda.current_stream(x.device) if x.is_cuda else None
        ev = record(src)
        out = []
        for s in self.slots:
            if not s.local:
                out.append(None)
                continue
            piece = x
            for dim, names in enumerate(spec):
                if names is None:
                    continue
                k, idx = self.extent(names), self.coord(s, names)
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

    def sync(self):
        """Wait on the host for every local slot's compute stream."""
        for s in self.slots:
            if s.stream is not None:
                s.stream.synchronize()

    def _sync_to(self, device: torch.device):
        """Order the caller's current stream on ``device`` after every
        local slot's compute stream (on the CPU: wait for them); returns
        that stream (None on the CPU)."""
        if device.type == "cuda":
            cs = torch.cuda.current_stream(device)
            for s in self.slots:
                wait(cs, record(s.stream))
            return cs
        self.sync()
        return None

    def join(self, t, device) -> torch.Tensor:
        """A result computed on the root slot (slot 0), for the caller on
        ``device``. On a mesh over several processes ``t`` is read in the
        root slot's process only (pass None elsewhere) and broadcast from
        it, so every process returns the result."""
        device = torch.device(device)
        if len(self.processes) == 1:
            keep(t, self._sync_to(device))
            return t.to(device)
        root = self.slots[0]
        if root.local:
            keep(t, self._sync_to(t.device))
            t = t.cpu()
        box = [t if root.local else None]
        dist.broadcast_object_list(box, src=root.process,
                                   group=self._group(self.processes))
        return box[0].to(device)

    def unshard(self, pieces: list, axis: str, device):
        """Concatenate back along the last dim the pieces of the slots along
        ``axis`` through slot 0, on ``device`` for the caller (in every
        process of the mesh)."""
        device = torch.device(device)
        group = self.group(self.slots[0], axis)
        if len(self.processes) > 1:
            ids = {m.index for m in group}
            st = self.all_gather([p if i in ids else None
                                  for i, p in enumerate(pieces)], axis)[0]
            with self.slots[0].on():
                out = torch.cat(list(st), -1) if st is not None else None
            return self.join(out, device)
        cs = self._sync_to(device)
        parts = []
        for s in group:
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
        has not run. A mesh whose axes cross processes raises: a graph
        holds one process's work.
        """
        if len(self.processes) > 1:
            self.require_local(tuple(a for a in self.axis_names
                                     if self.crossing(a)), "graphed")
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

    def _collect(self, dst: Slot, pairs) -> torch.Tensor:
        """Copy each (event, tensor) onto ``dst``, stacked on a new leading
        axis, on dst's copy stream after each tensor's event."""
        for ev, _ in pairs:
            wait(dst.copy_stream, ev)
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

    def _group(self, processes):
        """The process group of ``processes`` (the world's as None), one a
        set of processes for this mesh. ``dist.new_group`` is collective
        over the world: every process reaches it in the same order, since
        every process runs the same collectives on the same mesh."""
        ranks = tuple(sorted(processes))
        if ranks not in self._groups:
            self._groups[ranks] = (None if len(ranks) == dist.get_world_size()
                                   else dist.new_group(list(ranks)))
        return self._groups[ranks]

    def _exchange(self, members, values, ready, group) -> list:
        """The (event, tensor) pairs of a group that spans processes, in
        order along it: this process's members as they are, the others'
        through one ``dist.all_gather`` of each process's members stacked
        on its first member. Over Gloo a CUDA stack is staged through host
        memory (copied to the host, exchanged, copied back by the caller's
        ``_collect``), since Gloo moves host memory; over NCCL it stays on
        the card."""
        mine = [m for m in members if m.local]
        counts = {p: sum(m.process == p for m in members)
                  for p in {m.process for m in members}}
        if len(set(counts.values())) > 1:
            raise ValueError(f"a group spans processes unevenly: {counts}")
        s0 = mine[0]
        x = self._collect(s0, [(ready[m.index], values[m.index])
                               for m in mine])
        with s0.on():
            if x.is_cuda and dist.get_backend(group) == "gloo":
                x = x.cpu()           # staging: Gloo exchanges host memory
            bufs = [torch.empty_like(x) for _ in counts]
            dist.all_gather(bufs, x, group=group)
        ev = record(s0.stream)
        pos = {p: i for i, p in enumerate(sorted(counts))}
        seen = dict.fromkeys(counts, 0)
        pairs = []
        for m in members:
            k, seen[m.process] = seen[m.process], seen[m.process] + 1
            pairs.append((ready[m.index], values[m.index]) if m.local
                         else (ev, bufs[pos[m.process]][k]))
        return pairs

    def all_gather(self, values: list, axis) -> list:
        """Per slot (slot order), the values of its group along ``axis``
        stacked (extent of axis, ...) on the group's first slot, None
        elsewhere and at another process's slot. ``values`` holds a tensor
        or None per slot (None at another process's slot); a group with a
        value on its first slot must have one on every slot. A group that
        spans processes is exchanged through ``torch.distributed``
        (``_exchange``); whether it carries values must agree over its
        processes, as it does when they run the same program."""
        ready = self.ready()
        out = [None] * self.size
        for s in self.slots:
            if self.coord(s, axis):
                continue
            members = self.group(s, axis)
            procs = {m.process for m in members}
            if len(procs) > 1:
                group = self._group(procs)
                mine = [m for m in members if m.local]
                if not mine or values[mine[0].index] is None:
                    continue
                pairs = self._exchange(members, values, ready, group)
            elif s.local and values[s.index] is not None:
                pairs = [(ready[m.index], values[m.index]) for m in members]
            else:
                continue
            if s.local:
                out[s.index] = self._collect(s, pairs)
        return out

    def ppermute(self, values: list, partners: list) -> list:
        """Per local slot s, a copy onto s of ``values[partners[s]]``
        (partners as slot indices; None at another process's slot): a
        whole-shard pairwise exchange, as ``lax.ppermute``. ``values``
        holds a tensor at each local slot, alike over the slots. A partner
        in the same process is copied as it stands; the values bound for
        another process go as one stack a peer process (``routes``), on
        the first sending slot, through ``swap``. Over Gloo a CUDA stack
        is staged through host memory (copied to the host, exchanged, each
        row copied onto its slot); over NCCL it stays on the card."""
        ready = self.ready()
        out = [self._collect(s, [(ready[p], values[p])])[0]
               if s.local and self.slots[p].local else None
               for s, p in zip(self.slots, partners)]
        routes = self.routes(partners)
        if not routes:
            return out
        like = next(v for v in values if v is not None)
        host = not like.is_cuda or dist.get_backend() == "gloo"
        peers = {}
        for q, (src, dst) in routes.items():
            send = recv = None
            if src:
                s0 = self.slots[src[0]]
                send = self._collect(s0, [(ready[i], values[i])
                                          for i in src])
                if send.is_cuda and host:
                    with s0.on():
                        send = send.cpu()   # staging: Gloo moves host memory
                elif send.is_cuda:          # NCCL's stream cannot see s0's
                    s0.stream.synchronize()
            if dst:
                recv = torch.empty((len(dst),) + tuple(like.shape),
                                   dtype=like.dtype, device="cpu" if host
                                   else self.slots[dst[0]].device)
            peers[q] = send, recv
        self.swap(peers)
        for q, (_, dst) in routes.items():
            recv = peers[q][1]
            ev = None if host else record(torch.cuda.current_stream(
                recv.device))               # NCCL's wait lands there
            for k, i in enumerate(dst):
                out[i] = self._collect(self.slots[i], [(ev, recv[k])])[0]
        return out

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
