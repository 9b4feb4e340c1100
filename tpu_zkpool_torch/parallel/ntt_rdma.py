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
reach each other; that path needs two cards and has not run. A partner
owned by another process raises (``Mesh.require_pairs_local``): the
partner read has no cross-process form. Under
``exchange="ppermute"`` ``Mesh.ppermute`` copies each whole shard first,
as JAX's ``lax.ppermute`` does, and K9 combines with the copies.

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

import torch

from tpu_zkpool_torch import cuda_build
from tpu_zkpool_torch.fields import rlweq
from tpu_zkpool_torch.parallel.mesh import keep, record, wait

SOURCE = "ntt_rdma.cu"
MAX_SLOTS = 32          # csrc/ntt_rdma.cu kMaxSlots

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
            "ntt_max_slots": []})
        if (lib.ntt_stage_args_size() != ctypes.sizeof(StageArgs)
                or lib.ntt_max_slots() != MAX_SLOTS):
            raise RuntimeError("ntt_rdma.cu's StageArgs does not match the "
                               "wrapper's")
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
    card that this one has peer access to; every other tensor lies on the
    device of ``ys[0]``."""
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


def exchange_butterfly(mesh, ys, tws, u_sides, partners, exchange="rdma",
                       inverse=False):
    """One cross-shard butterfly stage over every slot of ``mesh``, one K9
    launch a device.

    ys: per slot (slot order) int32[B, S]; tws: per slot int32[S] (a
    pair's two slots alike for ``inverse``); u_sides: per slot bool;
    partners: per slot the partner's slot index. ``exchange="rdma"``: K9
    reads each partner's ``y``; ``"ppermute"``: it reads
    ``Mesh.ppermute``'s copies. Returns per slot a fresh int32[B, S],
    ready on the slot's compute stream."""
    if exchange == "rdma":
        mesh.require_pairs_local(partners, "K9's partner read")
        others = [ys[p] for p in partners]
    elif exchange == "ppermute":
        others = mesh.ppermute(ys, partners)
    else:
        raise ValueError(f"exchange must be 'rdma' or 'ppermute', got "
                         f"{exchange!r}")
    slots = mesh.slots
    groups = {}
    for s in slots:
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
                keep(t, ks)
            keep(out, slots[i].stream)
            wait(slots[i].stream, done)
            outs[i] = out
    return outs
