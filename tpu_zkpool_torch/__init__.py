"""PyTorch/CUDA port of ``tpu_zkpool`` for NVIDIA Hopper (H100).

The JAX package ``tpu_zkpool`` stays the reference; this package imports
``torch`` and numpy only, never ``jax`` and nothing of ``tpu_zkpool``. Field
elements keep the JAX layout at every public function: 16 little-endian
limbs of 16 bits in ``int64[..., 16]``, Montgomery with R = 2^256, so each
value equals the JAX ``uint32[..., 16]`` value limb for limb.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no CUDA device they raise instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev
