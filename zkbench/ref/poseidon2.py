"""Poseidon2 (t = 4) over BN254 Fr and the audit circuit's ct_commitment
sponge, in Python ints: a frozen copy of the host oracles of
``tpu_zkpool_torch/hash/poseidon2.py`` (``poseidon2_constants``,
``permutation_ref``, ``ct_commitment_ref``) for the benchmark's reference.
Barretenberg's Poseidon2 for BN254 (t = 4, R_F = 8, R_P = 56, x^5, the
external matrix M4, the internal matrix all-ones + diag(mu)).
"""

from __future__ import annotations

import functools

from zkbench.ref.bn254 import FR_MOD
from zkbench.ref.poseidon_params import _GrainLFSR

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
