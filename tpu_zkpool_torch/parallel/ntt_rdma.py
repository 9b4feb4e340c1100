"""Kernel K9 (``csrc/ntt_rdma.cu``): the cross-shard NTT butterfly, and the
chunked, overlapped shard exchange that feeds it.

K9 replaces the Pallas kernel ``tpu_zkpool/parallel/ntt_rdma.py``
(``_kernel`` / ``exchange_butterfly_rdma``, pallas_call l.161): one
cross-device stage of the sharded negacyclic NTT,

    out = u_side ? y + other : (other - y) * tw          (mod q, R = 2^28)

where ``other`` is the partner shard's ``y`` (partner = d ^ hd). The TPU
kernel moved the partner's rows itself, chunk by chunk into two receive
slots, with semaphores for flow control. Here ``exchange_butterfly`` runs
the same protocol with one slot's copy stream as the DMA engine and CUDA
events as the semaphores, and K9 is the combine of one chunk:

- the partner's chunk i is copied into receive slot i & 1 on the receiving
  slot's copy stream, after an event of the partner's compute stream;
- K9 on chunk i waits on an event recorded after that copy, so chunk i+1's
  copy overlaps chunk i's combine;
- the copy of chunk i+2 into slot i & 1 waits on an event recorded after
  K9 on chunk i (the TPU kernel's flow semaphore).

On CPU shards the same schedule runs the plain twin in order. The wrapper
``butterfly`` sends a CPU tensor to ``butterfly_plain``, raises
``ValueError`` for anything but int32 (rows, S) / (S,) tensors on either
device, and on a CUDA tensor launches K9 on the current stream, raises if
the launch reported an error, and adds one to
``LAUNCHES["exchange_butterfly"]``.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_zkpool_torch import cuda_build
from tpu_zkpool_torch.fields import rlweq
from tpu_zkpool_torch.parallel.mesh import keep, record, wait

SOURCE = "ntt_rdma.cu"
# Rows per exchanged chunk (the TPU kernel took 8, its sublane tile); 512
# rows of S words keep a copy and a launch well above their fixed costs.
CHUNK_ROWS = 512

# Launches since the last reset (the sharded NTT's evidence that it ran
# through the kernel).
LAUNCHES = {"exchange_butterfly": 0}

_lib = None


def reset_launches():
    LAUNCHES["exchange_butterfly"] = 0


def build(extra_flags=()) -> tuple:
    """Compile K9 unless its library exists: (path, nvcc output or None)."""
    return cuda_build.build(SOURCE, extra_flags)


def _load():
    global _lib
    if _lib is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _lib = cuda_build.load(SOURCE, {
            "ntt_exchange_butterfly": [P, P, P, P, I, I, I, P]})
    return _lib


def butterfly_plain(y, other, tw, u_side):
    """K9's plain twin (``ntt_rdma._butterfly``): int32 values < q."""
    if u_side:
        return rlweq.add(y, other)
    return rlweq.mont_mul(rlweq.sub(other, y), tw)


def butterfly(y, other, tw, u_side, out=None):
    """K9 on one chunk: y, other int32[rows, S], tw int32[S] -> int32[rows,
    S], written into ``out`` when given."""
    ts = (y, other, tw) + (() if out is None else (out,))
    if y.dim() != 2 or other.shape != y.shape or tuple(tw.shape) != (
            y.shape[1],) or (out is not None and out.shape != y.shape):
        raise ValueError(f"exchange_butterfly: want y, other (rows, S) and tw "
                         f"(S,), got {[tuple(t.shape) for t in ts]}")
    if any(t.dtype != rlweq.DTYPE for t in ts):
        raise ValueError(f"exchange_butterfly: want int32 values < q, got "
                         f"{[t.dtype for t in ts]}")
    if y.device.type == "cpu":
        res = butterfly_plain(y, other, tw, u_side)
        return res if out is None else out.copy_(res)
    cuda_build.check_tensors("exchange_butterfly", *ts, dtype=rlweq.DTYPE)
    if out is None:
        out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    cuda_build.launch(LAUNCHES, "exchange_butterfly", out.device,
                      _load().ntt_exchange_butterfly, y.data_ptr(),
                      other.data_ptr(), tw.data_ptr(), out.data_ptr(),
                      y.shape[0], y.shape[1], int(bool(u_side)))
    return out


def exchange_butterfly(mesh, ys, tws, u_sides, partners, chunk=CHUNK_ROWS):
    """One cross-shard butterfly stage over every slot of ``mesh``, the
    partner's rows moved in chunks of ``chunk`` rows (a short last chunk
    for any B >= 1) over two receive slots.

    ys: per slot (slot order) int32[B, S]; tws: per slot int32[S];
    u_sides: per slot bool; partners: per slot the partner's slot index.
    Returns per slot int32[B, S] on the slot's compute stream."""
    ready = mesh.ready()              # each partner's rows as they stand now
    outs = []
    for slot, y, tw, u, p in zip(mesh.slots, ys, tws, u_sides, partners):
        other = ys[p]
        B, S = y.shape
        bc = max(1, min(chunk, B))
        cs, ks = slot.copy_stream, slot.stream
        wait(cs, ready[p])
        keep(other, cs)
        with slot.on(copy=True):
            recv = torch.empty((2, bc, S), dtype=y.dtype, device=slot.device)
        keep(recv, ks)
        with slot.on():
            out = torch.empty_like(y)
        done = []
        for i, lo in enumerate(range(0, B, bc)):
            hi = min(B, lo + bc)
            buf = recv[i % 2, :hi - lo]
            if i >= 2:
                wait(cs, done[i - 2])  # K9 on chunk i-2 has read this slot
            with slot.on(copy=True):
                buf.copy_(other[lo:hi], non_blocking=True)
            wait(ks, record(cs))
            with slot.on():
                butterfly(y[lo:hi], buf, tw, u, out=out[lo:hi])
            done.append(record(ks))
        outs.append(out)
    return outs
