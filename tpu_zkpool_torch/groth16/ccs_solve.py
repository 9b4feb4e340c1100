"""Witness solver for gnark's committed CCS — proving gnark's ACTUAL rows.

The port's copy of ``tpu_zkpool/groth16/ccs_solve.py`` (host code), with one
departure: the ``hints.Randomize`` hint (the commitment-hiding randomizer)
draws from a generator passed to ``CcsSolver`` (by default the OS's
randomness), where the JAX module returns the constant 0x5EED. Every other
wire equals the JAX solver's on the same system and inputs.

``ccs.py`` decodes the committed withdraw constraint system (the reference
checkout's ``noir_circuit/target/shielded_pool_verifier.ccs``, SURVEY.md
§7.1 L4) into 12,452 R1C rows + 41 hint instructions in
calldata order.  This module EXECUTES that schedule: public + secret
wires come from the ACIR witness (gnark's secret wire names are
``__witness_<acir index>``), hints fill their output ranges, and each
R1C row either checks (all wires known) or solves its single unknown
wire — gnark's own solver semantics (constraint/r1cs_solver.go).

Hint functions are implemented from their calldata layouts and the
constraint structure that consumes them; hint outputs are existential
witnesses, so ANY assignment satisfying the subsequent rows is a valid
witness (bit-equality with gnark's solver is not required, satisfiability
is — and ``solve`` verifies every row).

The solved vector feeds the standard Groth16 pipeline over gnark's exact
rows: ``to_r1cs`` converts (with the bsb22 commitment challenge wire
permuted to the last public position, the layout
``refimpl.groth16_ref.setup(committed=...)`` expects).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

CONST = 0xFFFFFFFF          # Term wire id marking a constant coefficient
# Grumpkin (the embedded curve y^2 = x^3 - 17 over Fr) has group order
# equal to the BN254 BASE field — the emulated modulus of sunspot's
# sw-grumpkin GLV gadget (client/merkle.ts:47-74 uses the same curve).
GRUMPKIN_R = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# GLV endomorphism scalar: the cube root of unity mod GRUMPKIN_R that
# sunspot's decomposeScalar verifies against (pinned by test_ccs_solve
# against the mulHint coefficient table).
GLV_LAMBDA_BITS_CHECK = True


class CcsSolveError(ValueError):
    """The system or its assignment fails a check: an unsatisfied or
    non-linear row, a hint whose calldata or outputs do not fit. (The JAX
    module asserts these; here they raise under ``python -O`` too.)"""


def _require(cond, msg: str = "") -> None:
    if not cond:
        raise CcsSolveError(msg)


def _sqrt_mod(a: int, p: int) -> int:
    assert p % 4 == 3
    r = pow(a, (p + 1) // 4, p)
    assert r * r % p == a % p
    return r


def glv_lambda() -> int:
    """The cube root of unity mod GRUMPKIN_R used by the circuit:
    lambda = (-1 + sqrt(-3)) / 2 — the root whose 4x64-limb encoding
    appears in the committed mulHint coefficient table (191 bits)."""
    p = GRUMPKIN_R
    s = _sqrt_mod(p - 3, p)
    for cand in ((-1 + s) * pow(2, -1, p) % p, (-1 - s) * pow(2, -1, p) % p):
        assert (cand * cand + cand + 1) % p == 0
        if cand.bit_length() < 200:      # the table's 191-bit root
            return cand
    raise AssertionError("no small lambda root")


def decode_hint(call):
    """BlueprintGenericHint calldata -> ([input linear exprs], (lo, hi))."""
    cd = call.calldata
    n_in = cd[0]
    j = 1
    inputs = []
    for _ in range(n_in):
        m = cd[j]
        j += 1
        inputs.append([(cd[j + 2 * k], cd[j + 2 * k + 1]) for k in range(m)])
        j += 2 * m
    out = (cd[j], cd[j + 1])
    _require(j + 2 == len(cd), "hint calldata not fully consumed")
    return inputs, out


def split_scalar_glv(s: int, lam: int, r: int):
    """Find (s1, s2) with s1 = (s + lam*s2) mod r and both in [0, 2^127):
    the decomposition sunspot's in-circuit identity
    ``s + lam*s2 - s1 == 0 (mod r)`` range-checks to 127 bits per half.
    2D lattice Babai rounding + a local search (the box volume ~= det, so
    the closest points need a small neighbourhood scan)."""
    B = 1 << 127
    if s < B:
        return s, 0
    # lattice {(t, y): t == lam*y (mod r)}; Gauss-reduce basis
    v1, v2 = (r, 0), (lam, 1)

    def n2(v):
        return v[0] * v[0] + v[1] * v[1]

    while True:
        if n2(v2) < n2(v1):
            v1, v2 = v2, v1
        # round(<v1,v2>/<v1,v1>)
        num = v1[0] * v2[0] + v1[1] * v2[1]
        den = n2(v1)
        m = (2 * num + den) // (2 * den)
        if m == 0:
            break
        v2 = (v2[0] - m * v1[0], v2[1] - m * v1[1])
    # target: t in [-s, B - s), y in [0, B) -> center
    tx, ty = (B // 2 - s), (B // 2)
    det = v1[0] * v2[1] - v1[1] * v2[0]
    a_num = tx * v2[1] - ty * v2[0]
    b_num = v1[0] * ty - v1[1] * tx
    a0 = (2 * a_num + det) // (2 * det)
    b0 = (2 * b_num + det) // (2 * det)
    for da in range(-3, 4):
        for db in range(-3, 4):
            a, b = a0 + da, b0 + db
            t = a * v1[0] + b * v2[0]
            y = a * v1[1] + b * v2[1]
            s1 = s + t
            if 0 <= s1 < B and 0 <= y < B:
                assert (s + lam * y - s1) % r == 0
                return s1, y
    raise AssertionError("GLV split: no point in box near Babai rounding")


def _limbs64(v: int, n: int):
    return [(v >> (64 * i)) & ((1 << 64) - 1) for i in range(n)]


@dataclass
class SolveStats:
    rows_checked: int = 0
    rows_solved: int = 0
    hints_run: int = 0


class CcsSolver:
    """Executes the decoded schedule over gnark's wire space."""

    def __init__(self, gccs, commit_fn=None, debug=False, rng=None):
        """``rng``: the generator ``hints.Randomize`` draws from (anything
        with ``randrange``); by default ``random.SystemRandom()``."""
        self.g = gccs
        self.r = gccs.scalar_field
        self.w = [None] * gccs.nb_variables
        self.w[0] = 1
        self.commit_fn = commit_fn
        self.debug = debug
        self.rng = random.SystemRandom() if rng is None else rng
        self.stats = SolveStats()
        self.lam = glv_lambda()
        self._names = {hid: path.rsplit("/", 1)[-1]
                       for hid, path in gccs.hints.items()}

    # ------------------------------------------------------------ wiring

    def set_inputs(self, acir_witness: dict, n_public: int):
        """Public wires 1..n_public-1 = ACIR witnesses 0..n_public-2 (ABI
        order); secret wires follow gnark's ``__witness_<idx>`` names."""
        for k in range(n_public - 1):
            self.w[1 + k] = acir_witness[k] % self.r
        for i, name in enumerate(self.g.secret):
            idx = int(name.rsplit("_", 1)[-1])
            self.w[n_public + i] = acir_witness.get(idx, 0) % self.r

    def _eval_lc(self, terms):
        acc = 0
        for cid, wid in terms:
            c = self.g.coefficients[cid]
            if wid == CONST:
                acc += c
            else:
                v = self.w[wid]
                _require(v is not None,
                         f"unsolved wire {wid} in hint input")
                acc += c * v
        return acc % self.r

    # ------------------------------------------------------------- hints

    def run_hint(self, call):
        inputs, (lo, hi) = decode_hint(call)
        name = self._names[call.hint_id]
        outs = self._dispatch_hint(name, inputs, hi - lo)
        _require(len(outs) == hi - lo, f"{name}: {len(outs)} != {hi - lo}")
        for k, v in enumerate(outs):
            if v is None:
                continue                 # left for row-side solving
            self.w[lo + k] = v % self.r
        self.stats.hints_run += 1

    def _dispatch_hint(self, name, inputs, n_out):
        ev = self._eval_lc
        if name == "solver.InvZeroHint":
            v = ev(inputs[0])
            return [pow(v, -1, self.r) if v else 0]
        if name == "bits.nBits":
            v = ev(inputs[0])
            return [(v >> i) & 1 for i in range(n_out)]
        if name == "rangecheck.DecomposeHint":
            # (varSize, limbSize, value) -> little-endian limbs
            var_size, limb_size, v = (ev(t) for t in inputs)
            _require(n_out == -(-var_size // limb_size))
            return [(v >> (i * limb_size)) & ((1 << limb_size) - 1)
                    for i in range(n_out)]
        if name == "sw-grumpkin.decompose":
            # native scalar -> 4x64-bit emulated limbs
            return _limbs64(ev(inputs[0]), n_out)
        if name == "sw-grumpkin.decomposeScalar":
            # calldata: 6 lattice-shape constants, the scalar, nbLimbs=4,
            # limbSize=64, the 4 emulated-modulus limbs; outputs s1 and
            # s2 as 4x64 limbs each with s1 = (s + lambda*s2) mod r_emu,
            # both < 2^127 (the nBits(127) rows downstream pin the range)
            s = ev(inputs[6])
            s1, s2 = split_scalar_glv(s, self.lam, GRUMPKIN_R)
            return _limbs64(s1, 4) + _limbs64(s2, 4)
        if name == "emulated.mulHint":
            return self._mul_hint(inputs, n_out)
        if name == "logderivarg.countHint":
            # [nbTable, nbColumns, table entries..., queries...] ->
            # per-table-entry multiplicity among the queries (the check
            # row sums ONLY the query inverses; row 12429 of the
            # committed system has 426 query terms vs the 490-input call)
            nb_table = ev(inputs[0])
            _require(n_out == nb_table)
            table = [ev(t) for t in inputs[2:2 + nb_table]]
            index = {t: i for i, t in enumerate(table)}
            counts = [0] * nb_table
            for t in inputs[2 + nb_table:]:
                counts[index[ev(t)]] += 1
            return counts
        if name == "hints.Randomize":
            # commitment-hiding randomizer: any value satisfies the rows,
            # but a fixed one would hide nothing
            return [self.rng.randrange(self.r) for _ in range(n_out)]
        if name == "cs.Bsb22CommitmentComputePlaceholder":
            # challenge wire: hash-to-field of the Pedersen commitment
            # over the committed wires (computed with the proving key's
            # basis so prove() reproduces the identical commitment)
            _require(self.commit_fn is not None,
                     "committed CCS needs a commit_fn(committed_values)")
            vals = [ev(t) for t in inputs[1:]]
            return [self.commit_fn(vals)]
        raise NotImplementedError(f"hint {name}")

    def _mul_hint(self, inputs, n_out):
        """emulated.mulHint: quotient + carry-POLYNOMIAL witnesses for the
        deferred checkZero of ``e(X) == q(X) * p(X) + (2^64 - X) * c(X)``
        — gnark's random-evaluation multiplication check: the rows after
        the bsb22 commitment evaluate both sides at the challenge
        (e.g. row 12450: ``(2^64 - ch) * c(ch)``), and the identity at
        X = 2^64 gives the integer divisibility e = q*p.

        calldata: [limbSize, nbPLimbs, nbELimbs, nbQuoLimbs, p limbs,
        e limb values, 1]; outputs: q limbs, remainder limbs (zero and
        unconstrained for checkZero), then the deg-(nbELimbs-1) carry
        polynomial coefficients from exact synthetic division."""
        r = self.r
        limb_size = self._eval_lc(inputs[0])
        nb_p = self._eval_lc(inputs[1])
        nb_e = self._eval_lc(inputs[2])
        nb_q = self._eval_lc(inputs[3])
        p_limbs = [self._eval_lc(t) for t in inputs[4:4 + nb_p]]
        e_limbs = [self._eval_lc(t) for t in inputs[4 + nb_p:4 + nb_p + nb_e]]
        p = sum(v << (limb_size * i) for i, v in enumerate(p_limbs))
        e = sum(v << (limb_size * i) for i, v in enumerate(e_limbs))
        _require(e % p == 0,
                 "mulHint expression not divisible by the modulus")
        q = e // p
        quo = [(q >> (limb_size * i)) & ((1 << limb_size) - 1)
               for i in range(nb_q)]
        # diff(X) = e(X) - q(X)*p(X); synthetic division by (X - 2^64),
        # then negate for the (2^64 - X) factor the rows use.
        diff = [v % r for v in e_limbs] + [0] * max(0, nb_q + nb_p - 1 - nb_e)
        for i in range(nb_q):
            for j in range(nb_p):
                diff[i + j] = (diff[i + j] - quo[i] * p_limbs[j]) % r
        base = 1 << limb_size
        carries = [0] * (len(diff) - 1)
        t = list(diff)
        for i in range(len(diff) - 1, 0, -1):
            carries[i - 1] = t[i]
            t[i - 1] = (t[i - 1] + base * t[i]) % r
        _require(t[0] % r == 0, "mulHint: nonzero remainder at X = 2^64")
        cpoly = [(-v) % r for v in carries]
        n_rem = n_out - nb_q - len(cpoly)
        _require(n_rem >= 0)
        return quo + [0] * n_rem + cpoly

    # -------------------------------------------------------------- rows

    def solve_row(self, row, idx):
        """gnark R1C semantics: check if fully determined, else solve the
        single unknown wire (it may appear in several of L/R/O as long as
        the resulting equation is linear)."""
        r = self.r
        unknown = None
        for part in (row.L, row.R, row.O):
            for _, wid in part:
                if wid != CONST and self.w[wid] is None:
                    if unknown is None:
                        unknown = wid
                    elif unknown != wid:
                        raise CcsSolveError(
                            f"row {idx}: two unknowns {unknown}, {wid}")

        def split(part):
            """(known sum, coefficient of the unknown)."""
            k, cu = 0, 0
            for cid, wid in part:
                c = self.g.coefficients[cid]
                if wid == CONST:
                    k += c
                elif wid == unknown:
                    cu += c
                else:
                    k += c * self.w[wid]
            return k % r, cu % r

        lk, lu = split(row.L)
        rk, ru = split(row.R)
        ok, ou = split(row.O)
        if unknown is None:
            _require(lk * rk % r == ok, f"row {idx} unsatisfied")
            self.stats.rows_checked += 1
            return
        # (lk + lu x)(rk + ru x) = ok + ou x, linear in x required
        _require(not (lu and ru), f"row {idx}: quadratic in wire {unknown}")
        # x (lu*rk + lk*ru - ou) = ok - lk*rk
        a = (lu * rk + lk * ru - ou) % r
        b = (ok - lk * rk) % r
        if a == 0:
            _require(b == 0, f"row {idx}: inconsistent for wire {unknown}")
            self.w[unknown] = 0          # unconstrained here; 0 works
        else:
            self.w[unknown] = b * pow(a, -1, r) % r
        self.stats.rows_solved += 1

    # -------------------------------------------------------------- main

    def solve(self):
        for kind, idx in self.g.schedule:
            if kind == "hint":
                self.run_hint(self.g.hint_calls[idx])
            else:
                self.solve_row(self.g.constraints[idx], idx)
        missing = [i for i, v in enumerate(self.w) if v is None]
        _require(not missing,
                 f"{len(missing)} unsolved wires, first {missing[:5]}")
        return self.w

    def check_all(self):
        """Re-verify every row over the completed witness."""
        r = self.r
        for i, row in enumerate(self.g.constraints):
            def ev(part):
                acc = 0
                for cid, wid in part:
                    c = self.g.coefficients[cid]
                    acc += c if wid == CONST else c * self.w[wid]
                return acc % r
            _require(ev(row.L) * ev(row.R) % r == ev(row.O), f"row {i}")
        return True


# ------------------------------------------------------- R1CS conversion


def to_r1cs(gccs):
    """gnark rows -> our R1CS with the bsb22 challenge wire permuted to
    the last public slot (refimpl.groth16_ref.setup's committed layout).

    Returns (r1cs, committed, perm) where perm maps gnark wire id ->
    our wire id (apply to solved witnesses with ``permute_witness``).
    """
    from tpu_zkpool_torch.refimpl.groth16_ref import R1CS

    nv = gccs.nb_variables
    npub = gccs.nb_public
    challenge = None
    committed_g = []
    if gccs.commitments:
        ci = gccs.commitments[0]
        committed_g = list(ci["PrivateCommitted"])
        # the challenge wire is the Bsb22 placeholder hint's output
        for call in gccs.hint_calls:
            if "Bsb22" in gccs.hints[call.hint_id]:
                _, (lo, hi) = decode_hint(call)
                _require(hi - lo == 1)
                challenge = lo
    perm = [None] * nv
    for i in range(npub):
        perm[i] = i
    nxt = npub
    if challenge is not None:
        perm[challenge] = nxt
        nxt += 1
    for i in range(npub, nv):
        if perm[i] is None:
            perm[i] = nxt
            nxt += 1
    assert nxt == nv

    def conv(part):
        row = {}
        const_acc = 0
        for cid, wid in part:
            c = gccs.coefficients[cid]
            if wid == CONST:
                const_acc = (const_acc + c) % gccs.scalar_field
            else:
                w = perm[wid]
                row[w] = (row.get(w, 0) + c) % gccs.scalar_field
        if const_acc:
            row[0] = (row.get(0, 0) + const_acc) % gccs.scalar_field
        return {k: v for k, v in row.items() if v}

    a_rows, b_rows, c_rows = [], [], []
    for row in gccs.constraints:
        a_rows.append(conv(row.L))
        b_rows.append(conv(row.R))
        c_rows.append(conv(row.O))
    r1cs = R1CS(num_public=npub + (1 if challenge is not None else 0),
                num_vars=nv, a_rows=a_rows, b_rows=b_rows, c_rows=c_rows)
    committed = tuple(sorted(perm[i] for i in committed_g))
    return r1cs, committed, perm


def permute_witness(w, perm):
    out = [0] * len(w)
    for g, o in enumerate(perm):
        out[o] = w[g]
    return out
