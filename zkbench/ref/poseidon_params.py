"""Grain-LFSR generation of Poseidon round constants and MDS matrices.

Frozen for the benchmark's reference (``zkbench/ref``): it imports nothing
of the port, and later changes to the port do not reach it.

The port's own host copy of ``tpu_zkpool/hash/poseidon_params.py``. It
re-derives the circomlib/noir-lang Poseidon("1") parameters for BN254 from
the published generation procedure (Grain LFSR + Cauchy matrix, per the
Poseidon paper's reference ``generate_parameters_grain.sage``) instead of
vendoring the constant tables. The depth-16 default-subtree sibling chain of
the pool's client starts with
poseidon2(0,0) = 0x2098f5fb9e239eab3ceac3f27b81e481dc3124d55ffed523a839ee8446b64864,
which pins every one of these constants bit-exactly.

Generation parameters (circomlib convention): prime field (id 1),
x^5 S-box (id 0), n = 254 bits, t = arity + 1, R_F = 8 full rounds, R_P
partial rounds from the table below.
"""

from __future__ import annotations

import functools

from zkbench.ref.bn254 import FR_MOD

# Partial-round counts per t (index t-2), circomlib convention.
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
N_ROUNDS_F = 8


class _GrainLFSR:
    """80-bit Grain LFSR in self-shrinking mode, seeded per the Poseidon spec."""

    def __init__(self, field_id: int, sbox_id: int, n: int, t: int, r_f: int, r_p: int):
        bits = []
        for value, width in ((field_id, 2), (sbox_id, 4), (n, 12), (t, 12),
                             (r_f, 10), (r_p, 10)):
            bits.extend((value >> (width - 1 - i)) & 1 for i in range(width))
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._update()

    def _update(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_bit(self) -> int:
        # Self-shrinking: emit the second bit of each pair whose first bit is 1.
        while True:
            b1 = self._update()
            b2 = self._update()
            if b1 == 1:
                return b2

    def next_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.next_bit()
        return v

    def field_element(self, n_bits: int, p: int) -> int:
        # Rejection sampling: draw n_bits, retry until < p.
        while True:
            v = self.next_bits(n_bits)
            if v < p:
                return v


@functools.lru_cache(maxsize=None)
def poseidon_constants(t: int, p: int = FR_MOD, n_bits: int = 254):
    """Round constants and MDS matrix for Poseidon with state width t.

    Returns ``(C, M)`` where ``C`` is a flat list of (R_F+R_P)*t round
    constants (used t at a time, one group per round) and ``M`` is the t x t
    Cauchy MDS matrix, both as Python ints.
    """
    r_p = N_ROUNDS_P[t - 2]
    g = _GrainLFSR(1, 0, n_bits, t, N_ROUNDS_F, r_p)
    num_constants = (N_ROUNDS_F + r_p) * t
    C = [g.field_element(n_bits, p) for _ in range(num_constants)]

    # Cauchy MDS matrix from the same LFSR stream: M[i][j] = 1/(x_i + y_j).
    # The matrix draws do NOT use rejection sampling: a draw >= p is reduced
    # mod p rather than redrawn, unlike the round-constant draws (this is
    # what the circuit's constants and the sibling-chain vectors need).
    xs = [g.next_bits(n_bits) % p for _ in range(t)]
    ys = [g.next_bits(n_bits) % p for _ in range(t)]
    M = [[pow((xs[i] + ys[j]) % p, -1, p) for j in range(t)] for i in range(t)]
    return C, M


def poseidon_hash_ref(inputs, p: int = FR_MOD):
    """Pure-Python Poseidon hash (circomlib convention), the test oracle.

    state = [0, *inputs]; every round does ark -> sbox -> mix; output is
    state[0]. ``mix`` computes new[i] = sum_j M[i][j] * old[j].
    """
    t = len(inputs) + 1
    C, M = poseidon_constants(t, p)
    r_f, r_p = N_ROUNDS_F, N_ROUNDS_P[t - 2]
    state = [0] + [x % p for x in inputs]
    for r in range(r_f + r_p):
        state = [(a + C[r * t + i]) % p for i, a in enumerate(state)]
        if r < r_f // 2 or r >= r_f // 2 + r_p:
            state = [pow(a, 5, p) for a in state]
        else:
            state[0] = pow(state[0], 5, p)
        state = [
            sum(M[i][j] * state[j] for j in range(t)) % p
            for i in range(t)
        ]
    return state[0]
