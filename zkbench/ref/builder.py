"""R1CS circuit builder + crypto gadgets — the in-repo circuit frontend.

Frozen for the benchmark's reference (``zkbench/ref``): it imports nothing
of the port, and later changes to the port do not reach it.

The port's copy of ``tpu_zkpool/groth16/builder.py`` (host code), over the
port's ``refimpl.groth16_ref``, ``hash.poseidon_params``, ``hash.poseidon2``
and ``refimpl.pedersen``.

Replaces the reference's Noir-source code generation
(``scripts/generate_audit.py:246-465`` emits a ~50 MB main.nr and shells to
nargo/sunspot) with a direct R1CS builder: gadgets for Poseidon, Poseidon2,
bit/byte decomposition, signed range proofs, and constant-row inner
products, feeding our own Groth16 setup/prover.

Linear combinations are dicts {var_index: coeff}; var 0 is the constant 1.
Every auxiliary variable registers a compute callback so witnesses assemble
by one forward pass over the allocation order.
"""

from __future__ import annotations

from zkbench.ref.bn254 import FR_MOD as R
from zkbench.ref.groth16 import R1CS
from zkbench.ref.poseidon_params import (
    N_ROUNDS_F, N_ROUNDS_P, poseidon_constants,
)
from zkbench.ref import poseidon2 as p2mod


def lc(*terms) -> dict:
    """Build a linear combination from (coeff, var) pairs or a constant."""
    out = {}
    for t in terms:
        if isinstance(t, int):
            out[0] = (out.get(0, 0) + t) % R
        else:
            c, v = t
            out[v] = (out.get(v, 0) + c) % R
    return out


class CircuitBuilder:
    def __init__(self):
        self.num_vars = 1                # var 0 = constant 1
        self.num_public = 1
        self.a_rows: list = []
        self.b_rows: list = []
        self.c_rows: list = []
        self.computes: list = []         # (var, fn(witness)->value) in order

    # ------------------------------------------------------------ variables

    def public_input(self) -> int:
        assert self.num_vars == self.num_public, "declare publics first"
        v = self.num_vars
        self.num_vars += 1
        self.num_public += 1
        return v

    def private_input(self) -> int:
        v = self.num_vars
        self.num_vars += 1
        return v

    def aux(self, compute) -> int:
        v = self.num_vars
        self.num_vars += 1
        self.computes.append((v, compute))
        return v

    # ----------------------------------------------------------- constraints

    def constrain(self, a: dict, b: dict, c: dict) -> None:
        self.a_rows.append(dict(a))
        self.b_rows.append(dict(b))
        self.c_rows.append(dict(c))

    def assert_eq(self, x: dict, y: dict) -> None:
        diff = dict(x)
        for v, co in y.items():
            diff[v] = (diff.get(v, 0) - co) % R
        self.constrain(diff, {0: 1}, {})

    @staticmethod
    def _eval(l: dict, w: list) -> int:
        return sum(c * w[v] for v, c in l.items()) % R

    def mul(self, x: dict, y: dict) -> int:
        """New aux var z with constraint x * y = z."""
        z = self.aux(lambda w, x=dict(x), y=dict(y):
                     self._eval(x, w) * self._eval(y, w) % R)
        self.constrain(x, y, {z: 1})
        return z

    def square(self, x: dict) -> int:
        return self.mul(x, x)

    def pow5(self, x: dict) -> int:
        x2 = self.square(x)
        x4 = self.square({x2: 1})
        return self.mul({x4: 1}, x)

    def bits(self, x: dict, n: int) -> list:
        """Decompose x into n little-endian bits (adds n+1 constraints)."""
        bit_vars = []
        for i in range(n):
            b = self.aux(lambda w, x=dict(x), i=i:
                         (self._eval(x, w) >> i) & 1)
            self.constrain({b: 1}, {b: 1}, {b: 1})   # b^2 = b
            bit_vars.append(b)
        self.assert_eq(x, lc(*[(pow(2, i, R), b) for i, b in enumerate(bit_vars)]))
        return bit_vars

    # -------------------------------------------------------------- gadgets

    def poseidon_hash(self, inputs: list) -> int:
        """circomlib Poseidon of t-1 lc inputs -> output var."""
        t = len(inputs) + 1
        C, M = poseidon_constants(t)
        r_f, r_p = N_ROUNDS_F, N_ROUNDS_P[t - 2]
        state = [lc(0)] + [dict(x) for x in inputs]
        for r in range(r_f + r_p):
            state = [lc(s_i, C[r * t + i]) if False else
                     {**s_i, 0: (s_i.get(0, 0) + C[r * t + i]) % R}
                     for i, s_i in enumerate(state)]
            full = r < r_f // 2 or r >= r_f // 2 + r_p
            if full:
                state = [{self.pow5(s): 1} for s in state]
            else:
                state[0] = {self.pow5(state[0]): 1}
            new = []
            for i in range(t):
                acc = {}
                for j in range(t):
                    for v, co in state[j].items():
                        acc[v] = (acc.get(v, 0) + M[i][j] * co) % R
                new.append(acc)
            state = new
        out = self.aux(lambda w, s=dict(state[0]): self._eval(s, w))
        self.assert_eq(state[0], {out: 1})
        return out

    def poseidon2_permutation(self, state: list) -> list:
        """Poseidon2 t=4 on 4 lcs -> 4 lcs (sbox vars added)."""
        ext_rc, int_rc, diag = p2mod.poseidon2_constants()
        M4 = p2mod.M4

        def m4(s):
            out = []
            for i in range(4):
                acc = {}
                for j in range(4):
                    for v, co in s[j].items():
                        acc[v] = (acc.get(v, 0) + M4[i][j] * co) % R
                out.append(acc)
            return out

        s = m4([dict(x) for x in state])
        half = p2mod.R_F // 2
        for r in range(half):
            s = [{**si, 0: (si.get(0, 0) + ext_rc[r][i]) % R}
                 for i, si in enumerate(s)]
            s = [{self.pow5(si): 1} for si in s]
            s = m4(s)
        for r in range(p2mod.R_P):
            s0 = {**s[0], 0: (s[0].get(0, 0) + int_rc[r]) % R}
            s[0] = {self.pow5(s0): 1}
            tot = {}
            for si in s:
                for v, co in si.items():
                    tot[v] = (tot.get(v, 0) + co) % R
            # internal matrix row i = sum_j s_j + diag_i * s_i (diag holds
            # bb's mu-1 values)
            s = [
                {v: (tot.get(v, 0) + diag[i] * s[i].get(v, 0)) % R
                 for v in set(tot) | set(s[i])}
                for i in range(4)
            ]
        for r in range(half, p2mod.R_F):
            s = [{**si, 0: (si.get(0, 0) + ext_rc[r][i]) % R}
                 for i, si in enumerate(s)]
            s = [{self.pow5(si): 1} for si in s]
            s = m4(s)
        return s

    # ---------------------------------------------------------------- build

    def r1cs(self) -> R1CS:
        return R1CS(
            num_vars=self.num_vars,
            num_public=self.num_public,
            a_rows=self.a_rows,
            b_rows=self.b_rows,
            c_rows=self.c_rows,
        )

    def witness(self, assignment: dict) -> list:
        """Full witness from {input_var: value} (publics + private inputs)."""
        w = [0] * self.num_vars
        w[0] = 1
        for v, val in assignment.items():
            w[v] = val % R
        for v, fn in self.computes:
            w[v] = fn(w) % R
        return w
