"""Quotient witnesses of the RLWE audit circuit, in torch.

The port of ``tpu_zkpool/rlwe/quotient.py``. The audit circuit proves
c + k*q == <row, r> + noise over BN254 with integer quotients k, so the
inner products run over the integers (signed r, values up to ~2^40). As in
the JAX package, the mod-q negacyclic matrix is split into four 7-bit limb
matrices (entries 0..127) and each product is an int8 matrix product with
32-bit sums: every partial sum is at most 127 * 128 * 1,024 < 2^24, so it
is exact. The JAX package hands these four products to XLA (``jnp.matmul``
with int32 accumulation), outside any Pallas kernel; the port hands them to
``torch._int_mm`` on the card (int8 x int8 -> int32; it wants more than 16
rows and both widths a multiple of 8, so the batch is padded) and to an
int64 ``torch.matmul`` on the CPU. Neither goes through floats. The limbs
recombine in int64 on the tensors' device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch.refimpl.rlwe_ref import RLWE_Q

LIMB_BITS = 7
N_LIMBS = 4


@functools.lru_cache(maxsize=None)
def _negacyclic_limb_matrices(pk_key: tuple) -> tuple:
    """7-bit limb decomposition of the mod-q negacyclic matrix of ``pk``.

    A[k][j] = pk[k-j] for k >= j, else (q - pk[k-j+n]) mod q — the POSITIVE
    mod-q representatives, exactly as the circuit's constant rows; the
    quotient witnesses depend on this choice of representative. Returns 4
    int8 matrices A_l (entries in [0, 127]) with A = sum_l A_l * 2^(7l).
    """
    pk = np.asarray(pk_key, dtype=np.int64)
    n = pk.shape[0]
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    idx = (k - j) % n
    mat = np.where(k >= j, pk[idx], (RLWE_Q - pk[idx]) % RLWE_Q)
    limbs = []
    for l in range(N_LIMBS):
        limbs.append(((mat >> (LIMB_BITS * l)) & 0x7F).astype(np.int8))
    return tuple(limbs)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


@functools.lru_cache(maxsize=8)
def _device_limbs(pk_key: tuple, device: torch.device) -> tuple:
    """The transposed limb matrices A_l^T on ``device``: int8 (n8, n8)
    (zero-padded to a multiple of 8) on a CUDA device, int64 (n, n) on the
    CPU."""
    out = []
    for A in _negacyclic_limb_matrices(pk_key):
        At = np.ascontiguousarray(A.T)
        if device.type == "cuda":
            n8 = _pad8(At.shape[0])
            pad = np.zeros((n8, n8), dtype=np.int8)
            pad[:At.shape[0], :At.shape[1]] = At
            out.append(torch.as_tensor(pad, device=device))
        else:
            out.append(torch.as_tensor(At.astype(np.int64), device=device))
    return tuple(out)


def integer_negacyclic_products(pk, r_signed: torch.Tensor) -> torch.Tensor:
    """Exact integer products <A_k, r> for all rows k, batched over r.

    pk: sequence of N ints in [0, q); r_signed: integer tensor [..., N] of
    small entries (|r| <= 127). Returns int64[..., N] on r's device.
    """
    key = tuple(int(v) for v in pk)
    mats = _device_limbs(key, r_signed.device)
    n = len(key)
    lead = r_signed.shape[:-1]
    r = r_signed.reshape(-1, n)
    total = torch.zeros(r.shape, dtype=torch.int64, device=r.device)
    if r.device.type == "cuda":
        # _int_mm: more than 16 rows, widths a multiple of 8
        m, n8 = max(_pad8(r.shape[0]), 24), mats[0].shape[0]
        r8 = torch.zeros((m, n8), dtype=torch.int8, device=r.device)
        r8[:r.shape[0], :n] = r.to(torch.int8)
        for l, At in enumerate(mats):
            part = torch._int_mm(r8, At)[:r.shape[0], :n]
            total += part.to(torch.int64) << (LIMB_BITS * l)
    else:
        r64 = r.to(torch.int64)
        for l, At in enumerate(mats):
            total += torch.matmul(r64, At) << (LIMB_BITS * l)
    return total.reshape(lead + (n,))


def quotient_witnesses(pk, r_signed: torch.Tensor, extra) -> tuple:
    """k, rem with full = <A_k, r> + extra = k*q + rem, rem in [0, q).

    ``extra`` (a tensor or array) broadcasts against the row axis (e.g.
    e2[k], or e1[k] + DELTA*msg[k] on the sparse rows, zero-padded to N).
    Returns (k, rem) as int64 tensors on r's device (k can be negative).
    """
    full = integer_negacyclic_products(pk, r_signed) + torch.as_tensor(
        extra, dtype=torch.int64, device=r_signed.device)
    rem = torch.remainder(full, RLWE_Q)
    k = torch.div(full - rem, RLWE_Q, rounding_mode="floor")
    return k, rem
