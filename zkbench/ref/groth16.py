"""The plain reference that judges a Groth16 proof: the proof that the
prover must give for a witness, worked out in the exponent from the setup's
trapdoor, in Python ints.

The benchmark knows how the keys were made: ``setup(r1cs, seed)`` draws
tau, alpha, beta, gamma, delta as the first five ``randrange(1, r)`` of
``random.Random(seed)``. A proof with the blinding (r, s) is then

    A  = [alpha + U(tau) + r delta]_1
    B2 = [beta + V(tau) + s delta]_2
    C  = [(K + U(tau) V(tau) - W(tau)) / delta + s a + r b - r s delta]_1

with U(tau) = sum_c L_c(tau) (A_c . w) over the rows c (L_c the Lagrange
basis of the domain), V and W alike, a and b the scalars of A and B2, and
K = sum over private i of w_i (beta u_i + alpha v_i + w_i)(tau). H(X) t(X)
= U V - W holds as polynomials for a witness that satisfies every row, so
H(tau) t(tau) needs no transform. Each proof element is one scalar
multiplication of a generator: nothing of the prover's keys, tables or
points is read.
"""

from __future__ import annotations

import operator
import random
from dataclasses import dataclass

from zkbench.ref import ecc
from zkbench.ref.bn254 import FR_MOD as R


@dataclass
class R1CS:
    """Constraints as sparse rows {var_index: coeff}; w[0] = 1. Variables:
    [1, public..., private...]; ``num_public`` counts the constant too."""

    num_vars: int
    num_public: int
    a_rows: list
    b_rows: list
    c_rows: list


def trapdoor(seed: int) -> tuple:
    """(tau, alpha, beta, gamma, delta) of the keys set up from ``seed``."""
    rng = random.Random(seed)
    return tuple(rng.randrange(1, R) for _ in range(5))


def blinding(seed: int) -> tuple:
    """(r, s) of the proof made with the blinding seed ``seed``: the first
    two ``randrange(r)`` of ``random.Random(seed)``."""
    rng = random.Random(seed)
    return rng.randrange(R), rng.randrange(R)


def _domain(m: int) -> int:
    n = 1
    while n < m:
        n <<= 1
    return n


def lagrange_at(tau: int, m: int) -> list:
    """L_c(tau) = t(tau) w^c / (n (tau - w^c)) for the m rows of a domain of
    n = 2^k >= m points, w = 5^((r - 1) / n)."""
    n = _domain(m)
    omega = pow(5, (R - 1) // n, R)
    ws = [0] * m
    acc = 1
    for c in range(m):
        ws[c] = acc
        acc = acc * omega % R
    # one inversion for all m values (running products)
    diffs = [(tau - wc) % R for wc in ws]
    pre = [0] * m
    acc = 1
    for c, d in enumerate(diffs):
        pre[c] = acc
        acc = acc * d % R
    inv = pow(acc, -1, R)
    scale = (pow(tau, n, R) - 1) * pow(n, -1, R) % R
    out = [0] * m
    for c in range(m - 1, -1, -1):
        out[c] = scale * ws[c] % R * (pre[c] * inv % R) % R
        inv = inv * diffs[c] % R
    return out


class Judge:
    """One circuit under the keys of ``setup_seed``: the expected proof of a
    witness, and whether the witness satisfies every row.

    ``columns``, where given, are ``columns()`` of the same circuit and
    seed worked out before (a cache): U(tau), V(tau) and W(tau) of a
    witness are then three inner products with them (``at_tau``), and the
    rows and the Lagrange values are not read again."""

    def __init__(self, r1cs: R1CS, setup_seed: int, columns=None):
        self.r1cs = r1cs
        self.tau, self.alpha, self.beta, _, self.delta = trapdoor(setup_seed)
        self._lag = None
        self.cols = columns if columns is not None else self.columns()
        npub = r1cs.num_public
        self.pub_cols = [col[:npub] for col in self.cols]

    @property
    def lag(self) -> list:
        if self._lag is None:
            self._lag = lagrange_at(self.tau, len(self.r1cs.a_rows))
        return self._lag

    def columns(self) -> tuple:
        """(u_i(tau), v_i(tau), w_i(tau)) for every variable i: the sum over
        the rows c of L_c(tau) times i's coefficient in row c."""
        n = self.r1cs.num_vars
        cols = ([0] * n, [0] * n, [0] * n)
        for lc_, rows3 in zip(self.lag, zip(self.r1cs.a_rows,
                                            self.r1cs.b_rows,
                                            self.r1cs.c_rows)):
            for col, row in zip(cols, rows3):
                for v, co in row.items():
                    col[v] += co * lc_
        return tuple([x % R for x in col] for col in cols)

    def at_tau(self, w: list) -> tuple:
        """(U(tau), V(tau), W(tau)) of the witness ``w`` from the columns;
        None where ``w`` is not a witness of this circuit."""
        if len(w) != self.r1cs.num_vars or w[0] != 1:
            return None
        return tuple(sum(map(operator.mul, w, col)) % R
                     for col in self.cols)

    def evaluate(self, w: list) -> tuple:
        """(U(tau), V(tau), W(tau), rows the witness fails)."""
        if len(w) != self.r1cs.num_vars or w[0] != 1:
            return 0, 0, 0, len(self.lag)
        u = v = x = 0
        bad = 0
        for lc_, a, b, c in zip(self.lag, self.r1cs.a_rows,
                                self.r1cs.b_rows, self.r1cs.c_rows):
            ea = sum(co * w[i] for i, co in a.items()) % R
            eb = sum(co * w[i] for i, co in b.items()) % R
            ec = sum(co * w[i] for i, co in c.items()) % R
            if ea * eb % R != ec:
                bad += 1
            u += lc_ * ea
            v += lc_ * eb
            x += lc_ * ec
        return u % R, v % R, x % R, bad

    def expected(self, w: list, r: int, s: int, uvw=None) -> tuple:
        """The affine (A, B2, C) that the witness ``w`` with blinding
        (r, s) must give (``uvw``: ``evaluate(w)``'s first three, if
        known)."""
        u, v, x = (uvw or self.evaluate(w))[:3]
        npub = self.r1cs.num_public
        up, vp, xp = (sum(w[i] * col[i] for i in range(npub)) % R
                      for col in self.pub_cols)
        al, be, de = self.alpha, self.beta, self.delta
        a = (al + u + r * de) % R
        b = (be + v + s * de) % R
        k = (be * (u - up) + al * (v - vp) + (x - xp)) % R
        c = ((k + u * v - x) * pow(de, -1, R) + s * a + r * b
             - r * s * de) % R
        return (ecc.g1_mul(a, ecc.G1_GEN), ecc.g2_mul(b, ecc.G2_GEN),
                ecc.g1_mul(c, ecc.G1_GEN))
