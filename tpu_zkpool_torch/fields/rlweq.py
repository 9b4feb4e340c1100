"""Arithmetic mod q = 167772161 (= 40 * 2^22 + 1), the RLWE word field.

The port of ``tpu_zkpool/fields/rlweq.py``. Elements are int32 tensors
holding values in [0, q), each equal to the JAX package's uint32 value (CPU
torch lacks uint32 add, sub, shifts and compares; int32 has them all, and
q < 2^28 leaves room for a + b). Montgomery uses R = 2^28, as the JAX
package's 2 x 14-bit CIOS does: every twiddle table carries that R, so a
32-bit-word Montgomery (R = 2^32) would give other values. ``mont_mul``
widens to int64 (a * b < 2^56) and reduces by 2^28 once; its result in
[0, q) is unique, so it equals the JAX value bit for bit.

``from_numpy_u32`` / ``to_numpy_u32`` move values between the JAX layout
(numpy uint32) and the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device

Q = 167772161
W = 14                    # the JAX CIOS's limb width
R = 1 << (2 * W)          # Montgomery R = 2^28
R_MOD_Q = R % Q
R2_MOD_Q = (R * R) % Q
R_INV = pow(R, -1, Q)
QINV_NEG = (-pow(Q, -1, 1 << W)) % (1 << W)   # -q^-1 mod 2^14 (JAX CIOS)
QINV_NEG_R = (-pow(Q, -1, R)) % R             # -q^-1 mod 2^28

DTYPE = torch.int32


def from_numpy_u32(a, device=None) -> torch.Tensor:
    """uint32 values < q (numpy or JAX array) -> int32 tensor on ``device``
    (``cuda`` unless the caller names another; raises without a GPU)."""
    return torch.as_tensor(np.asarray(a).astype(np.int32),
                           device=resolve_device(device))


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of values < q -> numpy uint32 (the JAX layout)."""
    return t.cpu().numpy().astype(np.uint32)


def add(a, b):
    s = a + b
    return torch.where(s >= Q, s - Q, s)


def sub(a, b):
    return torch.where(a >= b, a - b, a + Q - b)


def neg(a):
    return torch.where(a == 0, a, Q - a)


def mont_mul(a, b):
    """a * b * R^-1 mod q, R = 2^28 (int64 product, one reduction)."""
    t = a.long() * b.long()                        # < q^2 < 2^56
    m = ((t & (R - 1)) * QINV_NEG_R) & (R - 1)     # t + m q = 0 mod R
    u = (t + m * Q) >> (2 * W)                     # < 2q
    return torch.where(u >= Q, u - Q, u).to(DTYPE)


def to_mont(a):
    return mont_mul(a, a.new_full((), R2_MOD_Q))


def from_mont(a):
    return mont_mul(a, a.new_full((), 1))


def pow_const(a_mont, e: int):
    """a^e (Montgomery in and out) for a Python-int exponent."""
    result = torch.full_like(a_mont, R_MOD_Q)
    base = a_mont
    while e:
        if e & 1:
            result = mont_mul(result, base)
        base = mont_mul(base, base)
        e >>= 1
    return result
