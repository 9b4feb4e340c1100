"""Conversions between Python ints and limb arrays.

A 254-bit field element is 16 little-endian limbs of 16 bits. The port keeps
them in ``int64`` (numpy on the host, torch on the device): torch on the CPU
has no uint32 add, subtract or shift, and int64 holds the column sums of a
16 x 16 limb product with room to spare.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device

NLIMB = 16
WBITS = 16
MASK = (1 << WBITS) - 1


def int_to_limbs(x: int, nlimb: int = NLIMB, wbits: int = WBITS) -> np.ndarray:
    """Encode a non-negative Python int as little-endian limbs (int64)."""
    assert x >= 0
    out = np.zeros((nlimb,), dtype=np.int64)
    mask = (1 << wbits) - 1
    for i in range(nlimb):
        out[i] = x & mask
        x >>= wbits
    assert x == 0, "value does not fit in limbs"
    return out


def limbs_to_int(limbs, wbits: int = WBITS) -> int:
    """Decode little-endian limbs (last axis) to a Python int."""
    limbs = np.asarray(limbs)
    assert limbs.ndim == 1
    x = 0
    for i in range(limbs.shape[0] - 1, -1, -1):
        x = (x << wbits) | int(limbs[i])
    return x


def ints_to_limbs(xs, nlimb: int = NLIMB) -> np.ndarray:
    """Encode a (nested) sequence of ints -> int64[..., nlimb] 16-bit limbs.

    Each int serializes once via ``int.to_bytes`` and the limb split is a
    vectorized uint16 view."""
    xs = np.asarray(xs, dtype=object)
    flat = xs.reshape(-1)
    nbytes = 2 * nlimb
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in flat.tolist())
    out = (np.frombuffer(buf, dtype="<u2")
           .reshape(flat.shape[0], nlimb).astype(np.int64))
    return out.reshape(xs.shape + (nlimb,))


def limbs_to_ints(limbs) -> np.ndarray:
    """Decode [..., nlimb] canonical 16-bit limbs (numpy or torch) -> object
    ndarray of Python ints."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    limbs = np.asarray(limbs)
    lead = limbs.shape[:-1]
    flat = limbs.reshape(-1, limbs.shape[-1])
    out = np.empty((flat.shape[0],), dtype=object)
    nbytes = 2 * flat.shape[-1]
    buf = np.ascontiguousarray(flat.astype("<u2")).tobytes()
    for k in range(flat.shape[0]):
        out[k] = int.from_bytes(buf[k * nbytes:(k + 1) * nbytes], "little")
    return out.reshape(lead)


def from_jax(arr, device=None) -> torch.Tensor:
    """JAX-layout Fr limbs (numpy or JAX uint32[..., 16], 16-bit limbs,
    Montgomery R = 2^256) -> the port's int64[..., 16] tensor on ``device``
    (``cuda`` unless the caller names another; raises without a GPU). The
    values carry over limb for limb; ``rlweq.from_numpy_u32`` is its
    counterpart for mod-q words."""
    a = np.asarray(arr)
    if a.shape[-1:] != (NLIMB,):
        raise ValueError(f"from_jax: want [..., {NLIMB}] limbs, got {a.shape}")
    return torch.as_tensor(a.astype(np.int64), device=resolve_device(device))


def pack_limbs16(limbs: np.ndarray) -> np.ndarray:
    """[..., 16] canonical 16-bit limbs -> uint32[..., 8] with two limbs per
    word (limb 2i in the low half, 2i+1 in the high half): the host-to-device
    wire format, half the bytes of the limb rows."""
    limbs = np.ascontiguousarray(np.asarray(limbs, dtype=np.uint32))
    assert limbs.shape[-1] % 2 == 0
    lo = limbs[..., 0::2]
    hi = limbs[..., 1::2]
    return (lo | (hi << np.uint32(16))).astype(np.uint32)


def unpack_limbs16(packed: torch.Tensor) -> torch.Tensor:
    """Device inverse of :func:`pack_limbs16`: [..., 8] words (any integer
    dtype holding values < 2^32) -> int64[..., 16] 16-bit limbs."""
    packed = packed.to(torch.int64) & 0xFFFFFFFF
    lo = packed & MASK
    hi = packed >> WBITS
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))
