"""Batched Poseidon permutation and hashes over BN254 Fr, in torch.

The port of ``tpu_zkpool/hash/poseidon.py``. States are ``int64[..., t, 16]``
Montgomery limbs (R = 2^256, as everywhere in the port) and every op
broadcasts over the leading batch axes, so one call hashes a whole batch.

One implementation per device: on a CUDA tensor :func:`hash_n` runs the
hand-written kernel K7 (``csrc/poseidon.cu`` through ``hash/kernels.py``); on
a CPU tensor it runs :func:`hash_n_plain`, the kernel's plain twin, which
repeats the JAX module op for op (add round constants, x^5 S-box, MDS mix as
one broadcast Montgomery product and t - 1 additions). The kernel, the twin
and the JAX package give the same canonical limbs.

The round constants and the MDS matrix are the slice's weights:
:func:`_mont_tables` derives them from the port's own ``poseidon_params``,
:func:`load_tables` puts such arrays (the port's, or the JAX package's
uint32 ones) on a device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.fields.limbs import NLIMB
# kernels imports this module for the plain twin; both only use each other's
# names inside functions, so the import cycle is benign.
from tpu_zkpool_torch.hash import kernels
from tpu_zkpool_torch.hash.poseidon_params import (N_ROUNDS_F, N_ROUNDS_P,
                                                   poseidon_constants)


@functools.lru_cache(maxsize=None)
def _mont_tables(t: int):
    """(c_pre, c_mid, c_post, m) as numpy int64 Montgomery limbs: the round
    constants of the first full rounds (R_F/2, t, 16), the partial rounds
    (R_P, t, 16) and the last full rounds (R_F/2, t, 16), and M (t, t, 16)."""
    C, M = poseidon_constants(t)
    r_f, r_p = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    C_rounds = np.array(
        [[C[r * t + i] for i in range(t)] for r in range(r_f + r_p)],
        dtype=object)
    half = r_f // 2
    c_pre = FR.to_mont(C_rounds[:half])
    c_mid = FR.to_mont(C_rounds[half:half + r_p])
    c_post = FR.to_mont(C_rounds[half + r_p:])
    m = FR.to_mont(np.array(M, dtype=object))
    return c_pre, c_mid, c_post, m


class Tables(NamedTuple):
    """Poseidon weights on one device, as the twin and the kernel read them."""
    rc: torch.Tensor   # int64 (R_F + R_P, t, 16): round constants, in order
    m: torch.Tensor    # int64 (t, t, 16): MDS matrix M[i][j]


def load_tables(arrays, device=None) -> Tables:
    """Four arrays (c_pre, c_mid, c_post, m) of Montgomery limbs, as
    ``_mont_tables`` gives them (the port's int64 or the JAX package's
    uint32), -> :class:`Tables` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    c_pre, c_mid, c_post, m = (np.asarray(a, dtype=np.int64) for a in arrays)
    rc = np.concatenate([c_pre, c_mid, c_post])
    return Tables(torch.as_tensor(rc, device=dev).contiguous(),
                  torch.as_tensor(m, device=dev).contiguous())


@functools.lru_cache(maxsize=None)
def tables(t: int, device: torch.device) -> Tables:
    """The port's own tables for width t on ``device`` (cached)."""
    return load_tables(_mont_tables(t), device)


def _x5(x):
    x2 = FR.mont_mul(x, x)
    x4 = FR.mont_mul(x2, x2)
    return FR.mont_mul(x4, x)


def _mix(state, m):
    """MDS: out[..., i, :] = sum_j M[i][j] * state[..., j, :], all t^2
    products as one broadcast Montgomery product."""
    t = m.shape[0]
    prod = FR.mont_mul(m, state[..., None, :, :])      # (..., t, t, 16)
    acc = prod[..., 0, :]
    for j in range(1, t):
        acc = FR.add(acc, prod[..., j, :])
    return acc


def permutation(state: torch.Tensor, t: int) -> torch.Tensor:
    """Poseidon permutation of Montgomery states int64[..., t, 16]: R_F/2
    full rounds, R_P partial rounds, R_F/2 full rounds."""
    rc, m = tables(t, state.device)
    half, r_p = N_ROUNDS_F // 2, N_ROUNDS_P[t - 2]
    for r in range(N_ROUNDS_F + r_p):
        state = FR.add(state, rc[r])
        if r < half or r >= half + r_p:
            state = _x5(state)
        else:
            state = torch.cat([_x5(state[..., :1, :]), state[..., 1:, :]], -2)
        state = _mix(state, m)
    return state


def hash_n_plain(inputs: torch.Tensor) -> torch.Tensor:
    """K7's plain twin: Poseidon of int64[..., n, 16] Montgomery inputs ->
    [..., 16], on the inputs' device, for any n the parameters cover."""
    zero = inputs.new_zeros(inputs.shape[:-2] + (1, NLIMB))
    state = torch.cat([zero, inputs], -2)
    return permutation(state, inputs.shape[-2] + 1)[..., 0, :]


def hash_n(inputs: torch.Tensor) -> torch.Tensor:
    """Poseidon hash of int64[..., n, 16] Montgomery inputs -> [..., 16].

    circomlib convention: state = [0, *inputs], output = state[0] after one
    permutation. Runs where the inputs are: K7 on a CUDA tensor (n = 1 ..
    16; other widths raise ``ValueError``), the plain twin on the CPU."""
    n = inputs.shape[-2]
    flat = inputs.reshape((-1, n, NLIMB)).contiguous()
    out = kernels.hash_tiles(flat, n + 1)
    return out.reshape(inputs.shape[:-2] + (NLIMB,))


def hash2(a, b):
    """Batched 2-ary Poseidon hash, int64[..., 16] Montgomery in and out."""
    return hash_n(torch.stack(torch.broadcast_tensors(a, b), dim=-2))


def hash3(a, b, c):
    return hash_n(torch.stack(torch.broadcast_tensors(a, b, c), dim=-2))


def hash4(a, b, c, d):
    return hash_n(torch.stack(torch.broadcast_tensors(a, b, c, d), dim=-2))


# ------------------------------------------------------------- host helpers

def hash_ints(*columns, device=None) -> np.ndarray:
    """Hash columns of Python ints (batched over the leading axis) on
    ``device`` (default ``cuda``) -> object ndarray of ints."""
    dev = resolve_device(device)
    limbs = torch.stack([torch.as_tensor(
        FR.to_mont(np.asarray(c, dtype=object)), device=dev)
        for c in columns], dim=-2)
    return FR.from_mont(hash_n(limbs))
