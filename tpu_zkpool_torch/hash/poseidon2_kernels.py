"""Wrapper of the Poseidon2 kernel P3 (``csrc/poseidon2.cu``).

P3 computes ``poseidon2.permutation_plain`` (form a) and
``poseidon2.ct_commitment_plain`` (form b), ``LANES`` = 16 lanes a state
or a ciphertext (four a state word, each product and addition split over
a word's lanes). It replaces no ``pl.pallas_call``: the JAX package runs
``tpu_zkpool/hash/poseidon2.py:permutation`` (l.155) and ``ct_commitment``
(l.181) as XLA scans. It has its own library (``cuda_build``), apart from
K7's. Each wrapper:

- raises ``ValueError`` on either device for inputs not shaped (B, 4, 16)
  (form a) or (B, n, 16) (form b), or not int64;
- sends a CPU tensor to the plain version;
- on a CUDA tensor checks dtype, device and contiguity, allocates the
  output with ``torch.empty``, launches on the current stream with the
  table of :func:`poseidon2.kernel_words` on that device, raises if the
  launch reported an error, and adds one to ``LAUNCHES["poseidon2"]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_zkpool_torch import cuda_build
from tpu_zkpool_torch.fields.limbs import NLIMB
from tpu_zkpool_torch.hash import poseidon2
from tpu_zkpool_torch.hash.kernels import block_size

SOURCE = "poseidon2.cu"
# threads a state (or a ciphertext's sponge), csrc/poseidon2.cu:kP2Lanes:
# SPLIT lanes a state word
SPLIT = 4
LANES = SPLIT * poseidon2.T

# Launches since the last reset (a path's evidence that it ran through the
# kernel).
LAUNCHES = {"poseidon2": 0}

_lib = None


def reset_launches():
    LAUNCHES["poseidon2"] = 0


def build(extra_flags=()) -> tuple:
    """Compile P3 unless its library exists: (path, nvcc output or None)."""
    return cuda_build.build(SOURCE, extra_flags)


def _load():
    global _lib
    if _lib is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        _lib = cuda_build.load(SOURCE, {"poseidon2": [P, P, P, I, I, I, I, P]})
    return _lib


@functools.lru_cache(maxsize=None)
def kernel_table(device: torch.device) -> torch.Tensor:
    """P3's table (``poseidon2.kernel_words``) on ``device`` (cached)."""
    return torch.as_tensor(poseidon2.kernel_words(),
                           device=device).contiguous()


def _check(x, name, width=None):
    if x.dim() != 3 or x.shape[-1] != NLIMB or (
            width is not None and x.shape[1] != width):
        want = f"(B, {width}, 16)" if width else "(B, n, 16)"
        raise ValueError(f"{name}: want {want} inputs, got {tuple(x.shape)}")
    if x.dtype != torch.int64:
        raise ValueError(f"{name}: want int64 limbs, got {x.dtype}")


def _launch(x, out, mode):
    B = x.shape[0]
    if B == 0:
        return out
    cuda_build.check_tensors("poseidon2", x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    cuda_build.launch(LAUNCHES, "poseidon2", x.device, _load().poseidon2,
                      x.data_ptr(), out.data_ptr(),
                      kernel_table(x.device).data_ptr(), B, x.shape[1], mode,
                      block_size(B * LANES, sms))
    return out


def permute(states):
    """P3, form a: int64[B, 4, 16] Montgomery states -> their Poseidon2
    permutations [B, 4, 16]."""
    _check(states, "poseidon2 permute", poseidon2.T)
    if states.device.type == "cpu":
        return poseidon2.permutation_plain(states)
    return _launch(states, torch.empty_like(states), 0)


def sponge(packed):
    """P3, form b: int64[B, n, 16] Montgomery fields -> the rate-3 sponge's
    output word [B, 16] (``ct_commitment``), any n >= 0."""
    _check(packed, "poseidon2 sponge")
    if packed.device.type == "cpu":
        return poseidon2.ct_commitment_plain(packed)
    out = torch.empty((packed.shape[0], NLIMB), dtype=torch.int64,
                      device=packed.device)
    return _launch(packed, out, 1)
