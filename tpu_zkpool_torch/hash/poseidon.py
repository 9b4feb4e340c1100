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

K7 runs the same permutation in the sparse form of the Poseidon paper's
appendix B (the form circomlib's ``poseidon_opt`` tables encode):
:func:`sparse_form` derives its tables exactly over Fr, with Python ints,
from the same dense constants and matrix, and :func:`kernel_tables` packs
them as 32-bit Montgomery words for the kernel.
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


def _mat_inv(A, p):
    """Inverse of the square matrix A of ints mod p (Gauss-Jordan)."""
    n = len(A)
    W = [list(row) + [int(i == j) for j in range(n)]
         for i, row in enumerate(A)]
    for c in range(n):
        piv = next(r for r in range(c, n) if W[r][c] % p)
        W[c], W[piv] = W[piv], W[c]
        inv = pow(W[c][c], -1, p)
        W[c] = [v * inv % p for v in W[c]]
        for r in range(n):
            if r != c and W[r][c]:
                f = W[r][c]
                W[r] = [(a - f * b) % p for a, b in zip(W[r], W[c])]
    return [row[n:] for row in W]


def _mat_mul(A, B, p):
    return [[sum(a * b for a, b in zip(row, col)) % p for col in zip(*B)]
            for row in A]


class SparseForm(NamedTuple):
    """The permutation in the Poseidon paper's sparse form (appendix B), as
    Python ints: every round r of width t adds its constants, applies x^5
    (to every wire in a full round, to wire 0 in a partial one) and mixes.

    - ``c_full`` (R_F, t): the full rounds' constants in order (the first
      R_F/2, then the last R_F/2);
    - ``k`` (R_P,): the partial rounds' constants, wire 0 only;
    - ``m`` (t, t): the MDS matrix, out_i = sum_j m[i][j] s_j, of every full
      round but the last of the first half, which mixes with ``pre``;
    - ``sparse`` (R_P, 2t - 1): partial round r mixes with the matrix
      [[w, v], [u, I]] stored as [w, v_1 .. v_{t-1}, u_1 .. u_{t-1}]:
      out_0 = w s_0 + sum_j v_j s_j, out_i = u_i s_0 + s_i.
    """
    c_full: list
    k: list
    m: list
    pre: list
    sparse: list


@functools.lru_cache(maxsize=None)
def sparse_form(t: int) -> SparseForm:
    """The sparse form of width t, derived exactly from the dense constants
    and MDS matrix of ``poseidon_params`` (the same function, so the same
    hashes):

    1. a partial round adds its constants' wires 1.. before an S-box that
       leaves them alone, so they pass through it and through the mix
       (M c) into the next round's constants, partial round by partial
       round, until the first full round of the second half takes them;
    2. each partial round's matrix W (M for the last) factors as W'' W'
       with W' = diag(1, W^) (W^ its lower right block) and W'' = [[w_00,
       w_0^ W^^-1], [w^_0, I]] sparse; W' commutes with the partial round
       before it (it leaves wire 0 alone), so it moves into that round's
       matrix, W' M, which factors in turn; the first partial round's W' M
       is the pre-matrix of the last full round before them."""
    C, M = poseidon_constants(t)
    p = FR.modulus
    r_f, r_p = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    half = r_f // 2
    c = [[C[r * t + i] for i in range(t)] for r in range(r_f + r_p)]
    for r in range(half, half + r_p):
        tail = [0] + c[r][1:]
        c[r] = [c[r][0]] + [0] * (t - 1)
        moved = [sum(m * x for m, x in zip(row, tail)) % p for row in M]
        c[r + 1] = [(a + b) % p for a, b in zip(c[r + 1], moved)]
    W, sparse = M, [None] * r_p
    for r in reversed(range(r_p)):
        hat = [row[1:] for row in W[1:]]
        hinv = _mat_inv(hat, p)
        v = [sum(W[0][1 + k] * hinv[k][j] for k in range(t - 1)) % p
             for j in range(t - 1)]
        u = [W[1 + i][0] for i in range(t - 1)]
        sparse[r] = [W[0][0]] + v + u
        W = _mat_mul([[1] + [0] * (t - 1)] + [[0] + row for row in hat], M, p)
    return SparseForm(c[:half] + c[half + r_p:], [c[r][0] for r in range(
        half, half + r_p)], [list(row) for row in M], W, sparse)


def mont_words(vals) -> np.ndarray:
    """Fr ints -> int32 (len, 8): each value in Montgomery form as 8
    little-endian 32-bit words, the kernels' table rows."""
    p, R = FR.modulus, 1 << 256
    words = [(v * R % p) >> (32 * w) & 0xFFFFFFFF for v in vals
             for w in range(8)]
    return np.array(words, dtype=np.uint32).view(np.int32).reshape(-1, 8)


@functools.lru_cache(maxsize=None)
def _kernel_words(t: int) -> np.ndarray:
    sf = sparse_form(t)
    return mont_words([x for row in sf.c_full for x in row] + list(sf.k) + [
        x for row in sf.m for x in row] + [x for row in sf.pre for x in row]
        + [x for row in sf.sparse for x in row])


@functools.lru_cache(maxsize=None)
def kernel_tables(t: int, device: torch.device) -> torch.Tensor:
    """K7's tables of width t on ``device``: int32 (E, 8), each row one Fr
    value in Montgomery form as 8 little-endian 32-bit words, in the order
    c_full (R_F x t), k (R_P), m (t x t), pre (t x t), sparse (R_P x (2t -
    1)) of :func:`sparse_form` (cached)."""
    return torch.as_tensor(_kernel_words(t), device=device).contiguous()


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
