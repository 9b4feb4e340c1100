"""Negacyclic NTT over q = 167772161 for the RLWE ring Z_q[x]/(x^n + 1).

The port of ``tpu_zkpool/rlwe/ntt.py``, value for value: a psi-twist, then
a decimation-in-frequency cyclic NTT (natural -> bit-reversed order) forward
and a decimation-in-time inverse (bit-reversed -> natural), so no
bit-reversal permutation is needed and pointwise products pair up. Each
butterfly stage is a reshape and two slices over the last axis, batched
over any leading axes. Data stays in the plain domain; every table is
pre-multiplied by R = 2^28, so ``mont_mul(data, table)`` is data * const.

The JAX package has no Pallas kernel here, and neither has the port: these
torch ops are the single-device reference that the sharded transform
(``parallel/ntt_sharded.py``) is held to.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch.fields import rlweq
from tpu_zkpool_torch.fields.rlweq import Q, R2_MOD_Q


def _find_generator(q: int = Q) -> int:
    factors = [2, 5]  # q - 1 = 2^25 * 5
    for g in range(2, 100):
        if all(pow(g, (q - 1) // f, q) != 1 for f in factors):
            return g
    raise RuntimeError("no generator found")


@functools.lru_cache(maxsize=None)
def _tables(n: int):
    """Host twiddle tables (Montgomery, numpy uint32) for size n:
    (twist, untwist, fwd stages h = n/2 .. 1, inv stages h = 1 .. n/2)."""
    g = _find_generator()
    psi = pow(g, (Q - 1) // (2 * n), Q)
    omega = psi * psi % Q
    psi_inv = pow(psi, -1, Q)
    omega_inv = pow(omega, -1, Q)
    n_inv = pow(n, -1, Q)
    # twist[i] = psi^i * R
    twist = np.array([pow(psi, i, Q) * rlweq.R % Q for i in range(n)],
                     dtype=np.uint32)
    # untwist[i] = psi^-i * n^-1 * R
    untwist = np.array(
        [pow(psi_inv, i, Q) * n_inv % Q * rlweq.R % Q for i in range(n)],
        dtype=np.uint32)
    # DIF forward stage with half-block h: w^(n/(2h) * j), j = 0..h-1
    fwd = []
    h = n // 2
    while h >= 1:
        step = n // (2 * h)
        fwd.append(np.array(
            [pow(omega, step * j, Q) * rlweq.R % Q for j in range(h)],
            dtype=np.uint32))
        h //= 2
    # DIT inverse stages in the reverse order (h = 1 .. n/2)
    inv = []
    h = 1
    while h <= n // 2:
        step = n // (2 * h)
        inv.append(np.array(
            [pow(omega_inv, step * j, Q) * rlweq.R % Q for j in range(h)],
            dtype=np.uint32))
        h *= 2
    return twist, untwist, fwd, inv


@functools.lru_cache(maxsize=None)
def device_tables(n: int, device: torch.device):
    """``_tables(n)`` as int32 tensors on ``device`` (cached)."""
    twist, untwist, fwd, inv = _tables(n)
    to = functools.partial(rlweq.from_numpy_u32, device=device)
    return to(twist), to(untwist), [to(t) for t in fwd], [to(t) for t in inv]


def dif_stage(y, tw):
    """One local DIF stage over the last axis (size a multiple of 2h)."""
    h = tw.shape[0]
    blocks = y.reshape(y.shape[:-1] + (y.shape[-1] // (2 * h), 2 * h))
    u, v = blocks[..., :h], blocks[..., h:]
    d = rlweq.mont_mul(rlweq.sub(u, v), tw)
    return torch.cat([rlweq.add(u, v), d], -1).reshape(y.shape)


def dit_stage(x, tw):
    """One local DIT stage over the last axis (size a multiple of 2h)."""
    h = tw.shape[0]
    blocks = x.reshape(x.shape[:-1] + (x.shape[-1] // (2 * h), 2 * h))
    u = blocks[..., :h]
    v = rlweq.mont_mul(blocks[..., h:], tw)
    return torch.cat([rlweq.add(u, v), rlweq.sub(u, v)], -1).reshape(x.shape)


def forward(x: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward NTT: int32[..., n] (< q) -> plain-domain spectrum
    in bit-reversed order, on x's device."""
    twist, _, fwd, _ = device_tables(x.shape[-1], x.device)
    y = rlweq.mont_mul(x, twist)                   # x * psi^i
    for tw in fwd:
        y = dif_stage(y, tw)
    return y


def inverse(y: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`forward`: bit-reversed spectrum -> int32[..., n]."""
    _, untwist, _, inv = device_tables(y.shape[-1], y.device)
    x = y
    for tw in inv:
        x = dit_stage(x, tw)
    return rlweq.mont_mul(x, untwist)              # x * psi^-i / n


def pointwise(fa, fb):
    """fa * fb mod q of two plain-domain spectra (two Montgomery products:
    fa fb R^-1, then * R^2 R^-1)."""
    prod = rlweq.mont_mul(fa, fb)
    return rlweq.mont_mul(prod, prod.new_full((), R2_MOD_Q))


def negacyclic_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negacyclic product of int32[..., n] polynomials mod q (batched)."""
    return inverse(pointwise(forward(a), forward(b)))
