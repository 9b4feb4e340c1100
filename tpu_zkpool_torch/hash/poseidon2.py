"""Poseidon2 (t = 4) permutation and the ct_commitment sponge over BN254 Fr.

The port of ``tpu_zkpool/hash/poseidon2.py``: Barretenberg's Poseidon2 for
BN254 (t = 4, R_F = 8, R_P = 56, x^5, the external matrix M4, the internal
matrix all-ones + diag(mu)), and the rate-3 / capacity-1 sponge that commits
the audit circuit's 157 packed ciphertext fields.

- ``poseidon2_constants``, ``permutation_ref`` and ``ct_commitment_ref`` are
  copies of the JAX module's host oracles (Python ints).
- ``permutation_plain`` and ``ct_commitment_plain`` are the plain versions of
  kernel P3 (``csrc/poseidon2.cu``) on ``FieldCtx``: int64[..., 4, 16] and
  int64[..., n, 16] Montgomery limbs, the JAX module's ``permutation`` and
  ``ct_commitment`` (l.155-199) step for step. The M4 mix is additions only,
  as there, its 16 scaled terms stacked into five calls.
- ``permutation`` and ``ct_commitment`` run where their input is: P3 on a
  CUDA tensor (``poseidon2_kernels``), the plain version on the CPU.

Every value is canonical, so P3, the plain versions and the JAX package
give the same limbs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch.fields.bn254 import FR_MOD
from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.fields.limbs import NLIMB
from tpu_zkpool_torch.hash.poseidon import mont_words
from tpu_zkpool_torch.hash.poseidon_params import _GrainLFSR

T = 4
R_F = 8
R_P = 56

M4 = [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]]

# Barretenberg's internal matrix diagonal (mu - 1 values): M_I row i =
# sum_j s_j + DIAG_M1[i] * s_i.
DIAG_M1 = [
    0x10dc6e9c006ea38b04b1e03b4bd9490c0d03f98929ca1d7fb56821fd19d3b6e7,
    0x0c28145b6a44df3e0149b3d0a30b3bb599df9756d4dd9b84a86b38cfb45a740b,
    0x00544b8338791518b2c7645a50392798b21f75bb60e3596170067d00141cac15,
    0x222c01175718386f2e2e82eb122789e352e105a3b8fa852613bc534433ee428b,
]


@functools.lru_cache(maxsize=None)
def poseidon2_constants(p: int = FR_MOD):
    """(external_rc [R_F][T], internal_rc [R_P], internal_diag_m1 [T]).

    Round constants come from the Grain LFSR in ROUND order (bb layout):
    the 4 pre-full rounds' 4 constants each, then one constant per internal
    round, then the 4 post-full rounds.
    """
    g = _GrainLFSR(1, 0, 254, T, R_F, R_P)
    half = R_F // 2
    ext_pre = [[g.field_element(254, p) for _ in range(T)] for _ in range(half)]
    internal = [g.field_element(254, p) for _ in range(R_P)]
    ext_post = [[g.field_element(254, p) for _ in range(T)] for _ in range(half)]
    return ext_pre + ext_post, internal, list(DIAG_M1)


# ------------------------------------------------------------ reference path

def permutation_ref(state, p: int = FR_MOD):
    """Pure-Python Poseidon2 permutation on a length-4 list of ints."""
    ext_rc, int_rc, diag = poseidon2_constants(p)

    def m4(s):
        return [sum(M4[i][j] * s[j] for j in range(T)) % p for i in range(T)]

    s = m4([x % p for x in state])
    half = R_F // 2
    for r in range(half):
        s = [(x + c) % p for x, c in zip(s, ext_rc[r])]
        s = [pow(x, 5, p) for x in s]
        s = m4(s)
    for r in range(R_P):
        s[0] = (s[0] + int_rc[r]) % p
        s[0] = pow(s[0], 5, p)
        tot = sum(s) % p
        s = [(tot + diag[i] * s[i]) % p for i in range(T)]
    for r in range(half, R_F):
        s = [(x + c) % p for x, c in zip(s, ext_rc[r])]
        s = [pow(x, 5, p) for x in s]
        s = m4(s)
    return s


def ct_commitment_ref(packed_fields, p: int = FR_MOD) -> int:
    """Rate-3 sponge over packed ciphertext fields (ct_helper/src/main.nr)."""
    state = [0, 0, 0, 0]
    n = len(packed_fields)
    full = n // 3
    for i in range(full):
        state[0] = (state[0] + packed_fields[3 * i]) % p
        state[1] = (state[1] + packed_fields[3 * i + 1]) % p
        state[2] = (state[2] + packed_fields[3 * i + 2]) % p
        state = permutation_ref(state, p)
    rem = n - full * 3
    if rem >= 1:
        state[0] = (state[0] + packed_fields[full * 3]) % p
    if rem >= 2:
        state[1] = (state[1] + packed_fields[full * 3 + 1]) % p
    state = permutation_ref(state, p)
    return state[0]


# ------------------------------------------------------------------ tables

@functools.lru_cache(maxsize=None)
def _mont_tables():
    """(ext (R_F, 4, 16), internal (R_P, 16), diag (4, 16)) as numpy int64
    Montgomery limbs."""
    ext, internal, diag = poseidon2_constants()
    return (FR.to_mont(np.array(ext, dtype=object)),
            FR.to_mont(np.array(internal, dtype=object)),
            FR.to_mont(np.array(diag, dtype=object)))


@functools.lru_cache(maxsize=None)
def tables(device: torch.device):
    """``_mont_tables`` as int64 tensors on ``device`` (cached)."""
    return tuple(torch.as_tensor(a, device=device) for a in _mont_tables())


@functools.lru_cache(maxsize=None)
def kernel_words() -> np.ndarray:
    """P3's table: int32 (96, 8), each row one Fr value in Montgomery form
    as 8 little-endian 32-bit words, in the order external constants (R_F x
    4, round order), internal constants (R_P), diagonal (4)."""
    ext, internal, diag = poseidon2_constants()
    return mont_words([x for row in ext for x in row] + list(internal)
                      + list(diag))


# --------------------------------------------------------- plain versions

def _m4_index() -> np.ndarray:
    """M4 by additions: every entry is a sum of 1, 2 and 4, so row i of
    M4 s is a sum of at most 8 terms 2^b s_j. Returns (4, 8) indices into
    the stacked multiples (s, 2 s, 4 s, 0): b * 4 + j, 12 for a zero."""
    rows = []
    for row in M4:
        terms = [b * T + j for j, m in enumerate(row) for b in range(3)
                 if m >> b & 1]
        rows.append(terms + [3 * T] * (8 - len(terms)))
    return np.array(rows)


_M4_INDEX = _m4_index()


def _m4_mix(s):
    """M4 on int64[..., 4, 16] by additions only: the doublings 2 s and
    4 s, then each row's eight terms summed as a tree."""
    s2 = FR.add(s, s)
    s4 = FR.add(s2, s2)
    mult = torch.cat([s, s2, s4, torch.zeros_like(s)], -2)    # (..., 16, 16)
    idx = torch.as_tensor(_M4_INDEX.reshape(-1), device=s.device)
    terms = mult.index_select(-2, idx).unflatten(-2, (T, 8))  # (..., 4, 8, 16)
    while terms.shape[-2] > 1:
        h = terms.shape[-2] // 2
        terms = FR.add(terms[..., :h, :], terms[..., h:, :])
    return terms[..., 0, :]


def _x5(x):
    x2 = FR.mont_mul(x, x)
    return FR.mont_mul(FR.mont_mul(x2, x2), x)


def permutation_plain(state: torch.Tensor) -> torch.Tensor:
    """P3's plain version: the Poseidon2 permutation of Montgomery states
    int64[..., 4, 16], on the states' device."""
    ext, internal, diag = tables(state.device)
    s = _m4_mix(state)
    half = R_F // 2
    for r in range(R_F):
        if r == half:
            for c in internal:
                s0 = _x5(FR.add(s[..., 0, :], c))
                s = torch.cat([s0[..., None, :], s[..., 1:, :]], -2)
                pair = FR.add(s[..., :2, :], s[..., 2:, :])
                tot = FR.add(pair[..., 0, :], pair[..., 1, :])
                s = FR.add(tot[..., None, :], FR.mont_mul(diag, s))
        s = _m4_mix(_x5(FR.add(s, ext[r])))
    return s


def ct_commitment_plain(packed: torch.Tensor) -> torch.Tensor:
    """P3's plain version of the sponge: int64[..., n, 16] Montgomery packed
    fields -> int64[..., 16], rate 3, the remainder absorbed into words
    0..rem-1 before the last permutation (any n >= 0)."""
    n = packed.shape[-2]
    full = n // 3
    state = packed.new_zeros(packed.shape[:-2] + (T, NLIMB))
    for i in range(full + 1):
        take = 3 if i < full else n - 3 * full
        if take:
            blk = packed[..., 3 * i:3 * i + take, :]
            state = torch.cat([FR.add(state[..., :take, :], blk),
                               state[..., take:, :]], -2)
        state = permutation_plain(state)
    return state[..., 0, :]


# ------------------------------------------------------------ entry points

def permutation(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of int64[..., 4, 16] Montgomery states: P3 on
    a CUDA tensor, the plain version on the CPU."""
    from tpu_zkpool_torch.hash import poseidon2_kernels
    flat = state.reshape((-1, T, NLIMB)).contiguous()
    return poseidon2_kernels.permute(flat).reshape(state.shape)


def ct_commitment(packed: torch.Tensor) -> torch.Tensor:
    """ct_commitment of int64[..., n, 16] Montgomery packed fields ->
    int64[..., 16]: P3 on a CUDA tensor, the plain version on the CPU."""
    from tpu_zkpool_torch.hash import poseidon2_kernels
    lead = packed.shape[:-2]
    flat = packed.reshape((lead.numel(),) + packed.shape[-2:]).contiguous()
    return poseidon2_kernels.sponge(flat).reshape(lead + (NLIMB,))
