"""Wrappers of the pairing kernels P1 and P2 (``csrc/pairing.cu``).

P1 ``k_miller_lines`` computes ``pairing.miller_loop_lines`` and P2
``k_final_exp`` computes ``pairing.final_exponentiation``, one warp a batch
element, two warps a block (``pairing.cu``'s ``kWarps``): each Fp12
operation runs as a lane program of ``pairing_program`` (a step's
independent Fp products one a lane), whose blob is uploaded once a device
and passed to both kernels with its first free slot (the launchers add the
kernels' own slots).
They replace no ``pl.pallas_call``: the JAX package compiles
``tpu_zkpool/curve/pairing_jax.py:miller_loop_lines`` (l.412) and
``:final_exponentiation`` (l.305) into one XLA program (``_ppl_jit``). The
library builds like the other kernel sources (``cuda_build``). Each
wrapper:

- checks shapes and dtypes on either device, and raises on what the kernel
  does not take;
- sends a CPU tensor to the plain version (``pairing.*_plain``);
- on a CUDA tensor checks dtype, device and contiguity, allocates the
  output with ``torch.empty``, launches on the current stream, raises if
  the launch reported an error, and adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_zkpool_torch import cuda_build
from tpu_zkpool_torch.curve import pairing_program
from tpu_zkpool_torch.curve.lines import N_STEPS, LineArrays

SOURCE = "pairing.cu"
MAX_LEGS = 3

# Launches since the last reset (a path's evidence that it ran through the
# kernels).
LAUNCHES = {"miller_lines": 0, "final_exp": 0}

_lib = None
_blobs = {}


class MillerArgs(ctypes.Structure):
    """``zk::MillerArgs`` of ``csrc/pairing.cu``, field for field: per leg
    the G1 point's x and y rows, the 12 line arrays in ``LineArrays``
    order and their batch stride in limbs (0 for a fixed leg)."""
    _fields_ = [("px", ctypes.c_void_p * MAX_LEGS),
                ("py", ctypes.c_void_p * MAX_LEGS),
                ("line", (ctypes.c_void_p * 12) * MAX_LEGS),
                ("stride", ctypes.c_longlong * MAX_LEGS),
                ("legs", ctypes.c_int),
                ("batch", ctypes.c_int)]


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(extra_flags=()) -> tuple:
    """Compile P1 and P2 unless their library exists: (path, nvcc output
    or None)."""
    return cuda_build.build(SOURCE, extra_flags)


def _load():
    global _lib
    if _lib is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib = cuda_build.load(SOURCE, {
            "miller_lines": [ctypes.POINTER(MillerArgs), P, I, P],
            "final_exp": [P, P, I, P, I]})
        lib.miller_args_size.restype = ctypes.c_int
        lib.miller_args_size.argtypes = []
        if lib.miller_args_size() != ctypes.sizeof(MillerArgs):
            raise RuntimeError("pairing.cu's MillerArgs does not match the "
                               "ctypes mirror")
        _lib = lib
    return _lib


def _blob(device):
    """(the lane programs' blob on ``device``, its first free slot)."""
    if device not in _blobs:
        blob = pairing_program.program()
        _blobs[device] = (torch.from_numpy(blob.view(np.int32)).to(device),
                          int(blob[0]))
    return _blobs[device]


def _check_legs(g1s, legs) -> int:
    """The batch B of a Miller loop's inputs; raises on a bad shape."""
    if not 1 <= len(g1s) == len(legs) <= MAX_LEGS:
        raise ValueError(f"miller_lines: want 1 to {MAX_LEGS} legs, one G1 "
                         f"point each, got {len(g1s)} and {len(legs)}")
    B = g1s[0][0].shape[0] if g1s[0][0].dim() == 2 else -1
    for (px, py), lg in zip(g1s, legs):
        if not isinstance(lg, LineArrays):
            raise ValueError("miller_lines: a leg is not a LineArrays")
        for t in (px, py):
            if tuple(t.shape) != (B, 16) or B < 1:
                raise ValueError(f"miller_lines: want G1 rows (B, 16) alike "
                                 f"over the legs, got {tuple(t.shape)}")
        lead = lg.dbl_an0.shape[1:-1]
        if lead not in ((), (B,)):
            raise ValueError(f"miller_lines: a leg's lines have batch "
                             f"{tuple(lead)}, the points {B}")
        for k, t in enumerate(lg):
            S = N_STEPS if k < 8 else 2
            if tuple(t.shape) != (S,) + tuple(lead) + (16,):
                raise ValueError(f"miller_lines: line array {k} is "
                                 f"{tuple(t.shape)}, want "
                                 f"{(S,) + tuple(lead) + (16,)}")
    for t in [t for p in g1s for t in p] + [t for lg in legs for t in lg]:
        if t.dtype != torch.int64 or t.device != g1s[0][0].device:
            raise ValueError(f"miller_lines: want int64 tensors on one "
                             f"device, got {t.dtype} on {t.device}")
    return B


def miller_lines(g1s, legs) -> torch.Tensor:
    """P1: the Miller loop over 1-3 legs. g1s: [(px, py)] int64[B, 16]
    Montgomery; legs: ``LineArrays``, each unbatched (a fixed leg, batch
    stride 0) or batched over B. Returns f int64[B, 12, 16]."""
    B = _check_legs(g1s, legs)
    dev = g1s[0][0].device
    if dev.type == "cpu":
        from tpu_zkpool_torch.curve import pairing
        return pairing.miller_loop_lines_plain(g1s, legs)
    tensors = [t for p in g1s for t in p] + [t for lg in legs for t in lg]
    cuda_build.check_tensors("miller_lines", *tensors)
    out = torch.empty((B, 12, 16), dtype=torch.int64, device=dev)
    args = MillerArgs(legs=len(legs), batch=B)
    for i, ((px, py), lg) in enumerate(zip(g1s, legs)):
        args.px[i] = px.data_ptr()
        args.py[i] = py.data_ptr()
        for k, t in enumerate(lg):
            args.line[i][k] = t.data_ptr()
        args.stride[i] = 16 if lg.dbl_an0.dim() == 3 else 0
    blob, first = _blob(dev)
    cuda_build.launch(LAUNCHES, "miller_lines", dev, _load().miller_lines,
                      ctypes.byref(args), blob.data_ptr(), first,
                      out.data_ptr())
    return out


def final_exp(f) -> torch.Tensor:
    """P2: f^((p^12-1)/r) for f int64[B, 12, 16] Montgomery."""
    if f.dim() != 3 or tuple(f.shape[1:]) != (12, 16) or f.shape[0] < 1:
        raise ValueError(f"final_exp: want f (B, 12, 16), got "
                         f"{tuple(f.shape)}")
    if f.dtype != torch.int64:
        raise ValueError(f"final_exp: want int64 limbs, got {f.dtype}")
    if f.device.type == "cpu":
        from tpu_zkpool_torch.curve import pairing
        return pairing.final_exponentiation_plain(f)
    cuda_build.check_tensors("final_exp", f)
    out = torch.empty_like(f)
    blob, first = _blob(f.device)
    cuda_build.launch(LAUNCHES, "final_exp", f.device, _load().final_exp,
                      f.data_ptr(), blob.data_ptr(), first, out.data_ptr(),
                      f.shape[0])
    return out
