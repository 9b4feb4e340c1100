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
- picks the kernel's layout from B, t and the card's SM count
  (:func:`layout`: one thread a hash where B fills the card, else a group
  of lanes a hash), allocates the output, launches on the current stream
  with the width's word tables (``poseidon.kernel_tables``), raises if the
  launch reported an error, and adds one to ``LAUNCHES["poseidon"]``.
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

# The lane layout runs up to LANE_HASHES hashes a SM: below that one thread
# a hash leaves the card's issue slots idle and pays a hash's whole chain
# of products in one thread (on the H100 the lanes win at t = 3 up to 8,192
# hashes and lose at 16,384). Above THREAD_MAX_T wires one thread's state
# outgrows its registers and the lanes win at every batch, so the kernel
# builds one thread a hash for t <= THREAD_MAX_T only.
LANE_HASHES = 64
THREAD_MAX_T = 12

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
                               {"poseidon_hash": [P, P, P, I, I, I, I, P]})
    return _lib


def group_lanes(t: int) -> int:
    """G, the lanes of one hash in the lane layout: the least power of two
    above t (a lane a wire and one for the partial rounds' w x)."""
    return 1 << t.bit_length()


def layout(B: int, t: int, sms: int) -> tuple:
    """(lanes, block) of K7 for B hashes of width t on a card of ``sms``
    SMs: lanes = G (:func:`group_lanes`) while B <= LANE_HASHES x sms or
    t > THREAD_MAX_T, else 0 (one thread a hash); block = the widest of
    128, 64, 32 threads that still gives every SM four blocks."""
    wide = B > LANE_HASHES * sms and t <= THREAD_MAX_T
    lanes = 0 if wide else group_lanes(t)
    return lanes, block_size(B * (lanes or 1), sms)


def block_size(threads: int, sms: int) -> int:
    """The widest of 128, 64, 32 threads a block that still gives each of
    ``sms`` SMs four blocks of ``threads``."""
    return next((n for n in (128, 64) if threads >= 4 * n * sms), 32)


def _launch(inputs, t: int, lanes: int, block: int):
    """K7 in the given layout (``layout``'s choice in ``hash_tiles``)."""
    B = inputs.shape[0]
    out = torch.empty((B, NLIMB), dtype=torch.int64, device=inputs.device)
    if B == 0:
        return out
    tab = poseidon.kernel_tables(t, inputs.device)
    cuda_build.launch(LAUNCHES, "poseidon", out.device,
                      _load().poseidon_hash, inputs.data_ptr(),
                      out.data_ptr(), tab.data_ptr(), B, t, lanes, block)
    return out


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
    sms = torch.cuda.get_device_properties(inputs.device).multi_processor_count
    return _launch(inputs, t, *layout(inputs.shape[0], t, sms))


def hash2_kernel(a, b):
    """K7 at t = 3 on int64[B, 16] Montgomery rows a, b -> [B, 16]."""
    return hash_tiles(torch.stack([a, b], dim=1), 3)


def hash4_kernel(a, b, c, d):
    """K7 at t = 5 on four int64[B, 16] Montgomery rows -> [B, 16]."""
    return hash_tiles(torch.stack([a, b, c, d], dim=1), 5)
