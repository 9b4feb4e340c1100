"""Wrapper of the affine-tree CUDA kernel K8 (``csrc/affine_tree.cu``).

K8 replaces the Pallas kernel ``tpu_zkpool/msm/affine_tree.py``
(``_make_tree_kernel`` / ``_chunk_call``, driven by ``tree_level_pallas``):
one level of affine pair additions with Montgomery batch inversion. It
takes the port's layout, int64[M, 32] rows (x limbs, then y limbs) and an
int64[M] flag plane, for any M, instead of the TPU's chunks of K x 1,024
lanes. It builds into its own library, so it builds beside K1-K6 and K7.
The wrapper:

- sends a CPU tensor to the plain twin, ``affine_tree.tree_level_plain``;
- checks a CUDA tensor's dtype, shape and contiguity and raises on anything
  the kernel does not take;
- picks the launch shape from M and the card's SM count
  (:func:`launch_shape`), allocates the outputs with ``torch.empty``,
  launches on the current stream, raises if the launch reported an error,
  and adds one to ``LAUNCHES["tree_level"]``.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_zkpool_torch import cuda_build
from tpu_zkpool_torch.msm import affine_tree

SOURCE = "affine_tree.cu"

# Launches since the last reset (the tree path's evidence that it ran
# through the kernel).
LAUNCHES = {"tree_level": 0}

# Launch shape: blocks of 128 or 32 threads, at most 8 pairs a thread, sized
# for about RESIDENT blocks on each SM (the kernel's launch bounds).
MAX_PAIRS = 8
RESIDENT = 4

_lib = None


def reset_launches():
    LAUNCHES["tree_level"] = 0


def build(extra_flags=()) -> tuple:
    """Compile K8 unless its library exists: (path, nvcc output or None)."""
    return cuda_build.build(SOURCE, extra_flags)


def _load():
    global _lib
    if _lib is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _lib = cuda_build.load(SOURCE,
                               {"tree_level": [P, P, P, P, P, I, I, I, I,
                                               P]})
    return _lib


def launch_shape(M: int, sms: int) -> tuple:
    """(threads a block, pairs a thread) of K8 for M pairs on a card of
    ``sms`` SMs: 128-thread blocks once M gives every SM two of them, else
    32-thread blocks (a narrow level's latency is the inverse plus the
    product tree, shorter over fewer threads); then as few pairs a thread
    as fill RESIDENT blocks a SM. On 132 SMs the prover's level 0 (163,840
    pairs) runs (128, 3), 56,880 pairs (128, 1), 29,500 (32, 2) and a few
    thousand (32, 1), one pair a thread."""
    nt = 128 if M >= 2 * 128 * sms else 32
    return nt, min(MAX_PAIRS, max(1, -(-M // (nt * RESIDENT * sms))))


def tree_level(L, R, fl, complete: bool):
    """K8. L, R int64[M, 32] affine Montgomery rows, fl int64[M] with bits
    1 (L is infinity) and 2 (R is infinity) -> (L + R rows int64[M, 32],
    infinity flags int64[M]), equal to ``tree_level_plain``."""
    if L.device.type == "cpu":
        return affine_tree.tree_level_plain(L, R, fl, complete)
    cuda_build.check_tensors("tree_level", L, R, fl)
    M = L.shape[0]
    if L.dim() != 2 or L.shape[1] != affine_tree.WORDS2 \
            or R.shape != L.shape or tuple(fl.shape) != (M,):
        raise ValueError(f"tree_level: want L, R (M, {affine_tree.WORDS2}) "
                         f"and fl (M,), got {tuple(L.shape)}, "
                         f"{tuple(R.shape)}, {tuple(fl.shape)}")
    if L.data_ptr() % 16 or R.data_ptr() % 16:
        raise ValueError("tree_level: L and R must start on 16 bytes (the "
                         "kernel loads two limbs at a time)")
    out = torch.empty_like(L)
    ofl = torch.empty_like(fl)
    if M == 0:
        return out, ofl
    nt, per = launch_shape(M, torch.cuda.get_device_properties(
        L.device).multi_processor_count)
    cuda_build.launch(LAUNCHES, "tree_level", out.device, _load().tree_level,
                      L.data_ptr(), R.data_ptr(), fl.data_ptr(),
                      out.data_ptr(), ofl.data_ptr(), M, int(complete), nt,
                      per)
    return out, ofl
