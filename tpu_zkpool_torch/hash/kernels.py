"""Wrapper of the Poseidon CUDA kernel K7 (``csrc/poseidon.cu``).

K7 replaces the Pallas kernel ``tpu_zkpool/hash/poseidon_pallas.py``
(``_make_kernel`` / ``_hash_tiles``). It takes the port's layout, int64[B,
t-1, 16] Montgomery limbs in and int64[B, 16] out, for any B, instead of the
TPU's (nb, t-1, 16, 8, 128) tiles of 1,024 hashes. The wrapper:

- raises ``ValueError`` on either device for inputs not shaped (B, t-1, 16);
- sends a CPU tensor to the plain twin, ``poseidon.hash_n_plain`` (any t);
- raises ``ValueError`` for a width t the kernel is not built for (it is
  built for every width the parameters cover, t = 2 .. 17) and for anything
  but a contiguous int64 CUDA tensor;
- allocates the output, launches on the current stream with the width's
  tables (``poseidon.tables``), raises if the launch reported an error, and
  adds one to ``LAUNCHES["poseidon"]``.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_zkpool_torch import cuda_build
from tpu_zkpool_torch.fields.limbs import NLIMB
from tpu_zkpool_torch.hash import poseidon

SOURCE = "poseidon.cu"
WIDTHS = tuple(range(2, 18))   # t = 2 .. 17: N_ROUNDS_P covers them

# Launches since the last reset (the main path's evidence that it ran
# through the kernel).
LAUNCHES = {"poseidon": 0}

_lib = None


def reset_launches():
    LAUNCHES["poseidon"] = 0


def build(extra_flags=()) -> tuple:
    """Compile K7 unless its library exists: (path, nvcc output or None)."""
    return cuda_build.build(SOURCE, extra_flags)


def _load():
    global _lib
    if _lib is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _lib = cuda_build.load(SOURCE,
                               {"poseidon_hash": [P, P, P, P, I, I, P]})
    return _lib


def hash_tiles(inputs, t: int):
    """K7. inputs int64[B, t-1, 16] Montgomery Fr -> int64[B, 16], the
    Poseidon hash of each row (state [0, *row], output wire 0)."""
    if inputs.dim() != 3 or tuple(inputs.shape[1:]) != (t - 1, NLIMB):
        raise ValueError(f"poseidon: want (B, {t - 1}, {NLIMB}) inputs, got "
                         f"{tuple(inputs.shape)}")
    if inputs.device.type == "cpu":
        return poseidon.hash_n_plain(inputs)
    if t not in WIDTHS:
        raise ValueError(f"poseidon: the kernel is built for widths "
                         f"{WIDTHS}, not t = {t}")
    cuda_build.check_tensors("poseidon", inputs)
    B = inputs.shape[0]
    out = torch.empty((B, NLIMB), dtype=torch.int64, device=inputs.device)
    if B == 0:
        return out
    rc, m = poseidon.tables(t, inputs.device)
    cuda_build.launch(LAUNCHES, "poseidon", out.device,
                      _load().poseidon_hash, inputs.data_ptr(),
                      out.data_ptr(), rc.data_ptr(), m.data_ptr(), B, t)
    return out


def hash2_kernel(a, b):
    """K7 at t = 3 on int64[B, 16] Montgomery rows a, b -> [B, 16]."""
    return hash_tiles(torch.stack([a, b], dim=1), 3)


def hash4_kernel(a, b, c, d):
    """K7 at t = 5 on four int64[B, 16] Montgomery rows -> [B, 16]."""
    return hash_tiles(torch.stack([a, b, c, d], dim=1), 5)
