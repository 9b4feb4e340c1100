"""R1CS circuit builder + crypto gadgets — the in-repo circuit frontend.

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

from dataclasses import dataclass, field

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.refimpl.groth16_ref import R1CS
from tpu_zkpool_torch.hash.poseidon_params import (
    N_ROUNDS_F, N_ROUNDS_P, poseidon_constants,
)
from tpu_zkpool_torch.hash import poseidon2 as p2mod


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
        # log-derivative range argument state (see range_value /
        # finalize_range_checks): k -> list of checked value lcs
        self._range_values: dict = {}
        self._committed: list = []       # wires the bsb22 commitment binds

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

    # ---------------------------------------- log-derivative range checks
    #
    # gnark-style lookup replacement (std/internal/logderivarg, the
    # mechanism behind the reference's "42x fewer constraints" claim,
    # README.md:49): range-checked values cost ONE inverse row each
    # instead of one row per bit. Soundness comes from the bsb22
    # commitment: the checked limbs + multiplicity counts are Pedersen-
    # committed, the challenge is the commitment's hash-to-field (a
    # public input the verifier derives), and the rational identity
    #   sum_i 1/(ch - v_i) == sum_t m_t/(ch - t),  t in [0, 2^k)
    # is checked at the challenge — exactly the committed withdraw CCS's
    # structure (rows 12424-12450 of shielded_pool_verifier.ccs, decoded
    # in groth16/ccs_solve.py).

    def commit_wire(self, v: int) -> int:
        """Register a wire to be bound by the bsb22 commitment."""
        self._committed.append(v)
        return v

    def range_value(self, x: dict, k: int) -> None:
        """Assert the value of lc ``x`` lies in [0, 2^k) via the
        log-derivative table. Every wire in ``x`` must be committed (or
        public) — the caller's responsibility, since the challenge is
        derived after the commitment only."""
        self._range_values.setdefault(k, []).append(dict(x))

    def limbs_logderiv(self, x: dict, n_bits: int, k: int = 8) -> list:
        """Decompose lc ``x`` into ceil(n_bits/k) committed k-bit limb
        wires, range-checked via the log-derivative table, with one
        recomposition row. A short top limb (n_bits % k) is checked
        scaled by 2^(k - rem) — the value lc trick of the committed
        CCS's row 12427."""
        n_limbs = -(-n_bits // k)
        limbs = []
        for i in range(n_limbs):
            v = self.aux(lambda w, x=dict(x), i=i, k=k:
                         (self._eval(x, w) >> (i * k)) & ((1 << k) - 1))
            self.commit_wire(v)
            rem = n_bits - i * k
            if rem >= k:
                self.range_value({v: 1}, k)
            else:
                self.range_value({v: pow(2, k - rem, R)}, k)
            limbs.append(v)
        self.assert_eq(x, lc(*[(pow(2, i * k, R), v)
                               for i, v in enumerate(limbs)]))
        return limbs

    def finalize_range_checks(self, v_challenge: int) -> tuple:
        """Emit the log-derivative identity rows for every table.

        ``v_challenge`` must be the LAST public input; its witness value
        is the commitment hash over ``committed_wires()`` (see
        ``witness_committed``). Adds, per table of size T with V checked
        values: V inverse rows + T count inverses + T products + 1 sum
        row. Returns the committed wire tuple for setup()."""
        for k in sorted(self._range_values):
            values = self._range_values[k]
            T = 1 << k

            _cache = {"wid": None, "cnt": None}

            def counts_of(w, values=values, T=T, _cache=_cache):
                if _cache["wid"] != id(w):
                    cnt = [0] * T
                    for x in values:
                        cnt[self._eval(x, w)] += 1
                    _cache.update(wid=id(w), cnt=cnt)
                return _cache["cnt"]

            count_vars = []
            for t in range(T):
                cv = self.aux(lambda w, t=t, counts_of=counts_of:
                              counts_of(w)[t])
                self.commit_wire(cv)
                count_vars.append(cv)
            inv_sum = {}
            for x in values:
                diff = {v_challenge: 1}
                for v, co in x.items():
                    diff[v] = (diff.get(v, 0) - co) % R
                iv = self.aux(lambda w, d=dict(diff):
                              pow(self._eval(d, w), -1, R))
                self.constrain(diff, {iv: 1}, {0: 1})
                inv_sum[iv] = 1
            term_sum = {}
            for t in range(T):
                diff = {v_challenge: 1, 0: (-t) % R}
                tiv = self.aux(lambda w, d=dict(diff):
                               pow(self._eval(d, w), -1, R))
                self.constrain(diff, {tiv: 1}, {0: 1})
                term = self.mul({count_vars[t]: 1}, {tiv: 1})
                term_sum[term] = 1
            self.assert_eq(inv_sum, term_sum)
        # hiding randomizer (gnark's hints.Randomize wire): committed,
        # unconstrained; memoized so the two-pass witness agrees
        memo = {}

        def rand_fn(w):
            if "v" not in memo:
                import secrets
                memo["v"] = secrets.randbelow(R)
            return memo["v"]

        self.commit_wire(self.aux(rand_fn))
        self._range_values = {}
        return tuple(sorted(set(self._committed)))

    def witness_committed(self, assignment: dict, v_challenge: int,
                          pk) -> list:
        """Two-pass witness assembly for committed circuits: pass 1 with
        challenge 0 fixes every committed wire, the Pedersen commitment
        over ``pk.basis`` derives the challenge (hash-to-field — the
        same value prove()/verify() compute), pass 2 fills the
        challenge-dependent inverse wires."""
        from tpu_zkpool_torch.refimpl import pedersen
        # pass-1 dummy challenge: R-1 cannot collide with any table entry
        # or checked value, so every (ch - v) inverse exists
        w = self.witness({**assignment, v_challenge: R - 1})
        vals = [w[i] for i in pk.committed]
        cm, _ = pedersen.commit(list(pk.basis), list(pk.basis_exp_sigma),
                                vals)
        ch = pedersen.commitment_to_field(cm)
        return self.witness({**assignment, v_challenge: ch})

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
