"""Kernel K9 (``csrc/ntt_rdma.cu``): one cross-shard NTT butterfly stage
over every slot of a mesh, one launch a device.

K9 replaces the Pallas kernel ``tpu_zkpool/parallel/ntt_rdma.py``
(``_kernel`` / ``exchange_butterfly_rdma``, pallas_call l.161): one
cross-device stage of the sharded negacyclic NTT. Slot d combines its shard
y with o, the shard of its partner d ^ hd, and its stage twiddle slice tw
(mod q, Montgomery R = 2^28):

    forward:  u side  y + o         v side  (o - y) * tw
    inverse:  u side  y + o * tw    v side  o - y * tw

The inverse form folds in the pre-scale that JAX applies to the v side
before its exchange (JAX then calls the kernel with tw = R mod q, which
makes its product the identity); the two slots of a pair pass the same
twiddle slice.

The TPU kernel moved the partner's rows itself with remote DMAs, chunk by
chunk into two receive slots, chunk i+1's transfer overlapping chunk i's
combine, a flow semaphore keeping a sender off a slot still being read.
That double buffering hides a link's latency behind compute on a chip
whose kernel cannot address its partner's memory. On one card every shard
already lies in device memory: under ``exchange="rdma"`` K9 reads the
partner's rows itself (o is the partner's own y), the loads are the
transfer and the warps in flight overlap them, so there is no receive
buffer, no copy and no chunk. A slot whose partner lives on another card
reads it over peer access, which ``exchange_butterfly`` enables once
(``cudaDeviceEnablePeerAccess``) and which raises where the cards cannot
reach each other; that path needs two cards and has not run. Under
``exchange="ppermute"`` ``Mesh.ppermute`` copies each whole shard first,
as JAX's ``lax.ppermute`` does, and K9 combines with the copies.

A partner owned by another process (a mesh over the processes of a
``torch.distributed`` runtime) is read through CUDA IPC, the counterpart
of the TPU kernel's remote copy to another chip of the slice. A stage
whose partners cross processes runs this protocol in every process:

1. Synchronize every local slot's compute stream: this process's shards
   are complete, and so are its K9 reads of the stage before.
2. Export each local shard that another process's slot reads: the handle
   of its allocation (``cudaIpcGetMemHandle``; a caching allocator's
   tensor is a suballocation, so its block's handle) and its offset in
   it, 72 bytes, sent to that process over ``Mesh.swap``; receive the
   partners' likewise. The exchange is the barrier: a process receives
   only after its peer has passed step 1.
3. Open each received handle once a (process, handle) and mesh
   (``cudaIpcOpenMemHandle``), and hand K9 the mapped base plus the
   offset as the partner's shard. K9 runs unchanged, one launch a device
   over this process's slots only.
4. Hold a reference to each exported shard until the next such exchange,
   which tells this process that its peers' K9 reads of it are done; the
   sharded NTT closes a transform with ``settle`` (step 1 and an empty
   exchange) for the last stage.

Opened handles are closed when the mesh is dropped or at exit. A CPU
mesh that crosses processes has no shared device memory, so there the
partner read raises ``ValueError``; its ppermute form runs. Where the
container refuses IPC the export or open raises ``RuntimeError`` with
CUDA's error name: the read never turns into a copy.

- ``stage``: K9 over slots of one device, on the current stream, one
  launch; a by-value struct carries every slot's pointers and side (at
  most ``MAX_SLOTS`` slots). CPU tensors run ``stage_plain``.
- ``butterfly``: ``stage`` over one tensor.
- ``exchange_butterfly``: the mesh-level stage, one launch a device.

Every wrapper raises ``ValueError`` for tensors that are not contiguous
int32 (rows, S) shards with a (S,) twiddle slice, on the launch's device,
on either device type; on CUDA tensors it launches K9 or raises, and adds
one to ``LAUNCHES["exchange_butterfly"]`` a launch.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch
import torch.distributed as dist

from tpu_zkpool_torch import cuda_build
from tpu_zkpool_torch.fields import rlweq
from tpu_zkpool_torch.parallel.mesh import keep, record, wait

SOURCE = "ntt_rdma.cu"
MAX_SLOTS = 32          # csrc/ntt_rdma.cu kMaxSlots
HANDLE_BYTES = 64       # sizeof(cudaIpcMemHandle_t)

# Launches since the last reset (the sharded NTT's evidence that it ran
# through the kernel).
LAUNCHES = {"exchange_butterfly": 0}

_P = ctypes.c_void_p


class StageArgs(ctypes.Structure):
    """``zk::StageArgs`` of ``csrc/ntt_rdma.cu``, field for field."""
    _fields_ = [("y", _P * MAX_SLOTS), ("other", _P * MAX_SLOTS),
                ("tw", _P * MAX_SLOTS), ("out", _P * MAX_SLOTS),
                ("rows", ctypes.c_int64), ("u_mask", ctypes.c_uint32),
                ("S", ctypes.c_int32), ("slots", ctypes.c_int32),
                ("inverse", ctypes.c_int32), ("vec", ctypes.c_int32)]


_lib = None
_peers = set()
_ipc = weakref.WeakKeyDictionary()       # mesh -> its _IpcState


def reset_launches():
    LAUNCHES["exchange_butterfly"] = 0


def build(extra_flags=()) -> tuple:
    """Compile K9 unless its library exists: (path, nvcc output or None)."""
    return cuda_build.build(SOURCE, extra_flags)


def load():
    """Build and load K9's library once (before any CUDA graph capture)."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE, {
            "ntt_exchange_butterfly": [ctypes.POINTER(StageArgs), _P],
            "ntt_enable_peer": [ctypes.c_int], "ntt_stage_args_size": [],
            "ntt_max_slots": [], "ntt_ipc_handle_size": [],
            "ntt_ipc_export": [_P, _P, ctypes.POINTER(ctypes.c_ulonglong)],
            "ntt_ipc_open": [_P, ctypes.POINTER(_P)],
            "ntt_ipc_close": [_P]})
        for name in ("ntt_error_name", "ntt_error_string"):
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_char_p
        if (lib.ntt_stage_args_size() != ctypes.sizeof(StageArgs)
                or lib.ntt_max_slots() != MAX_SLOTS
                or lib.ntt_ipc_handle_size() != HANDLE_BYTES):
            raise RuntimeError("ntt_rdma.cu's StageArgs or IPC handle does "
                               "not match the wrapper's")
        _lib = lib
    return _lib


def butterfly_plain(y, other, tw, u_side, inverse=False):
    """K9's plain twin on one slot (``ntt_rdma._butterfly`` forward; JAX's
    v-side pre-scale, then ``_butterfly`` with tw = R mod q, inverse)."""
    if inverse:
        if u_side:
            return rlweq.add(y, rlweq.mont_mul(other, tw))
        return rlweq.sub(other, rlweq.mont_mul(y, tw))
    if u_side:
        return rlweq.add(y, other)
    return rlweq.mont_mul(rlweq.sub(other, y), tw)


def stage_plain(ys, others, tws, u_sides, inverse=False):
    """The stage's twin: ``butterfly_plain`` slot by slot."""
    return [butterfly_plain(y, o, t, u, inverse)
            for y, o, t, u in zip(ys, others, tws, u_sides)]


def _check(ys, others, tws, outs):
    n = len(ys)
    if not 1 <= n <= MAX_SLOTS or not len(others) == len(tws) == len(
            outs) == n:
        raise ValueError(f"exchange_butterfly: want 1 to {MAX_SLOTS} slots "
                         f"with a y, other, tw and out each, got {n}")
    shape = tuple(ys[0].shape)
    for y, o, t, out in zip(ys, others, tws, outs):
        ts = (y, o, t) + (() if out is None else (out,))
        if y.dim() != 2 or tuple(y.shape) != shape or o.shape != y.shape or (
                tuple(t.shape) != (shape[1],)) or (
                out is not None and out.shape != y.shape):
            raise ValueError(f"exchange_butterfly: want y, other (rows, S) "
                             f"alike over the slots and tw (S,), got "
                             f"{[tuple(u.shape) for u in ts]} beside "
                             f"{shape}")
        if any(u.dtype != rlweq.DTYPE for u in ts):
            raise ValueError(f"exchange_butterfly: want int32 values < q, "
                             f"got {[u.dtype for u in ts]}")
        if not all(u.is_contiguous() for u in ts):
            raise ValueError("exchange_butterfly: want contiguous tensors")


def stage(ys, others, tws, u_sides, inverse=False, outs=None):
    """K9 over the slots of one device, one launch on the current stream:
    per slot y, other int32[rows, S] (alike over the slots), tw int32[S],
    u side; writes into ``outs`` where given. ``other`` may lie on another
    card that this one has peer access to, or be a ``Mapped`` shard of
    another process; every other tensor lies on the device of ``ys[0]``."""
    outs = [None] * len(ys) if outs is None else list(outs)
    _check(ys, others, tws, outs)
    dev = ys[0].device
    if dev.type == "cpu":
        res = stage_plain(ys, others, tws, u_sides, inverse)
        return [r if o is None else o.copy_(r) for r, o in zip(res, outs)]
    if dev.type != "cuda":
        raise ValueError(f"exchange_butterfly: tensors must be on a CUDA "
                         f"device, got {dev}")
    for y, o, t, out in zip(ys, others, tws, outs):
        if any(u.device != dev for u in (y, t) + (
                () if out is None else (out,))) or (
                o.device.type != "cuda" or (o.device != dev and (
                    dev.index, o.device.index) not in _peers)):
            raise ValueError(f"exchange_butterfly: want every y, tw and out "
                             f"on {dev} and other there or on a peer card, "
                             f"got {y.device}, {o.device}, {t.device}")
    outs = [torch.empty_like(y) if o is None else o for y, o in zip(ys, outs)]
    rows, S = ys[0].shape
    if rows * S == 0:
        return outs
    args = StageArgs(rows=rows, S=S, slots=len(ys), inverse=int(inverse))
    for i, (y, o, t, out, u) in enumerate(zip(ys, others, tws, outs,
                                              u_sides)):
        args.y[i], args.other[i] = y.data_ptr(), o.data_ptr()
        args.tw[i], args.out[i] = t.data_ptr(), out.data_ptr()
        args.u_mask |= int(bool(u)) << i
    ptrs = list(args.y) + list(args.other) + list(args.tw) + list(args.out)
    args.vec = int(S % 4 == 0 and all((p or 0) % 16 == 0 for p in ptrs))
    cuda_build.launch(LAUNCHES, "exchange_butterfly", dev,
                      load().ntt_exchange_butterfly, ctypes.byref(args))
    return outs


def butterfly(y, other, tw, u_side, inverse=False):
    """K9 on one shard: y, other int32[rows, S], tw int32[S] -> int32[rows,
    S]."""
    return stage([y], [other], [tw], [u_side], inverse)[0]


def enable_peer(dev: torch.device, peer: torch.device):
    """Let ``dev`` read ``peer``'s memory (once a pair); raises where the
    two cards cannot reach each other."""
    if (dev.index, peer.index) in _peers:
        return
    if not torch.cuda.can_device_access_peer(dev, peer):
        raise RuntimeError(f"exchange_butterfly: {dev} cannot read {peer} "
                           f"(no peer access between the cards)")
    with torch.cuda.device(dev):
        rc = load().ntt_enable_peer(peer.index)
    if rc != 0:
        raise RuntimeError(f"exchange_butterfly: enabling peer access "
                           f"{dev} -> {peer} failed with error {rc}")
    _peers.add((dev.index, peer.index))


def _cuda_error(what: str, rc: int) -> RuntimeError:
    lib = load()
    return RuntimeError(f"{what} failed with CUDA error {rc} "
                        f"({lib.ntt_error_name(rc).decode()}: "
                        f"{lib.ntt_error_string(rc).decode()})")


def ipc_export(t: torch.Tensor) -> tuple:
    """(handle of the allocation that holds CUDA tensor ``t``, ``t``'s byte
    offset in it); raises ``RuntimeError`` naming CUDA's error."""
    handle = ctypes.create_string_buffer(HANDLE_BYTES)
    offset = ctypes.c_ulonglong()
    with torch.cuda.device(t.device):
        rc = load().ntt_ipc_export(t.data_ptr(), handle, ctypes.byref(offset))
    if rc != 0:
        raise _cuda_error("cudaIpcGetMemHandle", rc)
    return handle.raw, offset.value


def ipc_open(handle: bytes, device: torch.device) -> int:
    """Map another process's allocation into ``device``'s context: its
    base address here. Raises ``RuntimeError`` naming CUDA's error."""
    ptr = _P()
    with torch.cuda.device(device):
        rc = load().ntt_ipc_open(ctypes.create_string_buffer(
            handle, HANDLE_BYTES), ctypes.byref(ptr))
    if rc != 0:
        raise _cuda_error("cudaIpcOpenMemHandle", rc)
    return ptr.value


def ipc_close(ptr: int, device: torch.device):
    with torch.cuda.device(device):
        rc = load().ntt_ipc_close(ptr)
    if rc != 0:
        raise _cuda_error("cudaIpcCloseMemHandle", rc)


class Mapped:
    """A partner shard of another process, mapped here by CUDA IPC: what
    ``stage`` reads of a tensor (its address, shape, dtype, device)."""

    def __init__(self, ptr: int, like: torch.Tensor):
        self.ptr, self.shape = ptr, like.shape
        self.dtype, self.device = like.dtype, like.device

    def data_ptr(self) -> int:
        return self.ptr

    def is_contiguous(self) -> bool:
        return True


class _IpcState:
    """A mesh's opened handles ((process, handle) -> (base, device)), the
    shards it exported and holds until the next exchange, and the peers of
    that exchange."""

    def __init__(self, mesh):
        self.opened, self.held, self.peers = {}, [], ()
        weakref.finalize(mesh, _close_all, self.opened)


def _close_all(opened: dict):
    for base, device in opened.values():
        ipc_close(base, device)
    opened.clear()


def _wire(mesh) -> torch.device:
    """Where the protocol's records travel: host memory over Gloo, the
    card over NCCL (which moves device memory only)."""
    if dist.is_initialized() and dist.get_backend() != "gloo":
        return next(s.device for s in mesh.slots if s.local)
    return torch.device("cpu")


def partner_reads(mesh, ys, partners) -> list:
    """Per local slot, the shard K9 reads as its partner's: the partner's
    own ``y`` in this process, a ``Mapped`` one in another (the module
    docstring's protocol)."""
    slots = mesh.slots
    others = [ys[p] if s.local and slots[p].local else None
              for s, p in zip(slots, partners)]
    routes = mesh.routes(partners)
    if not routes:
        return others
    if any(s.device.type != "cuda" for s in slots if s.local):
        raise ValueError("K9's partner read across processes maps the "
                         "partner's shard by CUDA IPC, and a CPU mesh has "
                         "no shared device memory: use exchange='ppermute'")
    state = _ipc.get(mesh)
    if state is None:
        state = _ipc[mesh] = _IpcState(mesh)
    mesh.sync()                     # step 1: my shards are complete
    wire = _wire(mesh)
    peers = {}
    for q, (src, dst) in routes.items():
        send = None
        if src:
            rows = []
            for i in src:
                handle, offset = ipc_export(ys[i])
                rows.append(np.frombuffer(handle, dtype=np.int64).tolist()
                            + [offset])
            send = torch.tensor(rows, dtype=torch.int64, device=wire)
        recv = (torch.empty((len(dst), HANDLE_BYTES // 8 + 1),
                            dtype=torch.int64, device=wire) if dst else None)
        peers[q] = send, recv
    mesh.swap(peers)                # step 2, the barrier
    state.held = [ys[i] for src, _ in routes.values() for i in src]
    state.peers = tuple(routes)
    for q, (_, dst) in routes.items():
        records = peers[q][1].cpu().numpy() if dst else None
        for k, i in enumerate(dst):
            handle = records[k, :-1].tobytes()
            dev = slots[i].device
            if (q, handle) not in state.opened:
                state.opened[q, handle] = ipc_open(handle, dev), dev
            base = state.opened[q, handle][0]
            others[i] = Mapped(base + int(records[k, -1]), ys[i])
    return others


def settle(mesh):
    """Close a run of cross-process partner reads on ``mesh``: synchronize
    and swap an empty record with the last exchange's peers, so that each
    process's exported shards are released only after its peers' K9 reads
    of them are done. A no-op where nothing is held."""
    state = _ipc.get(mesh)
    if state is None or not state.peers:
        return
    mesh.sync()
    wire = _wire(mesh)
    mesh.swap({q: (torch.zeros(1, dtype=torch.int64, device=wire),
                   torch.empty(1, dtype=torch.int64, device=wire))
               for q in state.peers})
    state.held, state.peers = [], ()


def exchange_butterfly(mesh, ys, tws, u_sides, partners, exchange="rdma",
                       inverse=False):
    """One cross-shard butterfly stage over every slot of ``mesh``, one K9
    launch a device.

    ys: per slot (slot order) int32[B, S], None at another process's
    slot; tws: per slot int32[S] (a pair's two slots alike for
    ``inverse``; None at another process's slot); u_sides: per slot bool;
    partners: per slot the partner's slot index. ``exchange="rdma"``: K9
    reads each partner's ``y`` (by CUDA IPC in another process, the
    module docstring's protocol); ``"ppermute"``: it reads
    ``Mesh.ppermute``'s copies. Returns per local slot a fresh int32[B,
    S], ready on the slot's compute stream (None at another process's
    slot)."""
    if exchange == "rdma":
        others = partner_reads(mesh, ys, partners)
    elif exchange == "ppermute":
        others = mesh.ppermute(ys, partners)
    else:
        raise ValueError(f"exchange must be 'rdma' or 'ppermute', got "
                         f"{exchange!r}")
    slots = mesh.slots
    groups = {}
    for s in slots:
        if s.local:
            groups.setdefault(s.device, []).append(s.index)
    ready = mesh.ready()            # every shard and copy as it stands now
    outs = [None] * len(slots)
    for dev, idx in groups.items():
        for i in idx:
            if others[i].device != dev:
                enable_peer(dev, others[i].device)
        ks = slots[idx[0]].stream
        for ev in ready:
            wait(ks, ev)
        with slots[idx[0]].on():
            res = stage([ys[i] for i in idx], [others[i] for i in idx],
                        [tws[i] for i in idx], [u_sides[i] for i in idx],
                        inverse)
        done = record(ks)
        for i, out in zip(idx, res):
            for t in (ys[i], others[i], tws[i]):
                if isinstance(t, torch.Tensor):      # not a Mapped shard
                    keep(t, ks)
            keep(out, slots[i].stream)
            wait(slots[i].stream, done)
            outs[i] = out
    return outs
