"""The RLWE audit circuit, built directly as R1CS.

Frozen for the benchmark's reference (``zkbench/ref``): it imports nothing
of the port, and later changes to the port do not reach it.

The port's copy of ``tpu_zkpool/protocol/audit_circuit.py`` (host code),
over the port's builder, gadgets, ``refimpl.rlwe_ref`` and
``hash.poseidon2``.

Our equivalent of the reference's generated Noir audit circuit
(``scripts/generate_audit.py:246-465``; the ~50 MB main.nr is stripped from
the repo — the generator is ground truth, SURVEY.md §7.3 item 7):

Proves, for public (wa_commitment, ct_commitment):
  - wa_commitment = Poseidon1(owner_x, owner_y)
  - ct_commitment = Poseidon2 rate-3 sponge over the 157 packed ciphertext
    fields (bound as private inputs)
  - byte-encoding: msg slots = little-endian bytes of owner_x / owner_y
  - range proofs r, e1, e2 in [-128, 128]
  - the BFV encryption identities over BN254 with quotient witnesses:
      c0[i] + k0[i]*Q == <PK_B_ROW[i], r> + e1[i] + DELTA*msg[i]   (64 rows)
      c1[i] + k1[i]*Q == <PK_A_ROW[i], r> + e2[i]                  (1024 rows)
    with the negacyclic PK rows embedded as circuit constants.

The owner point's curve derivation is CONSTRAINED in-circuit: secret_key
is split into 128-bit limbs and bound via the fixed-base scalar-mul gadget
(``groth16/gadgets.py``), matching the reference's
``fixed_base_scalar_mul(scalar)`` at ``scripts/generate_audit.py:417-422``.
"""

from __future__ import annotations

from dataclasses import dataclass

from zkbench.ref.bn254 import FR_MOD as R
from zkbench.ref.builder import CircuitBuilder, lc
from zkbench.ref.gadgets import fixed_base_scalar_mul_gadget
from zkbench.ref.rlwe import (
    DELTA, MSG_SLOTS, N, PACK_BITS, PACK_WIDTH, RLWE_Q,
    negacyclic_matrix_row, pack_values,
)

PACKED_C0 = (MSG_SLOTS + PACK_WIDTH - 1) // PACK_WIDTH   # 10
PACKED_C1 = (N + PACK_WIDTH - 1) // PACK_WIDTH           # 147


@dataclass
class AuditCircuit:
    builder: CircuitBuilder
    v_wa: int
    v_ct: int
    v_owner_x: int
    v_owner_y: int
    v_sk: int
    v_c0_packed: list
    v_c1_packed: list
    v_r: list
    v_e1: list
    v_e2: list
    v_k0: list
    v_k1: list
    v_pka: list = ()
    v_pkb: list = ()
    pk_values: tuple = ()    # (pk_a, pk_b) ints for var_pk assignment

    def assignment(self, owner_x: int, owner_y: int, enc: dict,
                   wa: int, ct: int, sk: int) -> dict:
        """Input map from an encryption record (refimpl.rlwe_ref.encrypt)."""
        a = {self.v_wa: wa, self.v_ct: ct,
             self.v_owner_x: owner_x, self.v_owner_y: owner_y,
             self.v_sk: sk}
        c0p = pack_values(enc["c0_sparse"])
        c1p = pack_values(enc["c1"])
        for v, val in zip(self.v_c0_packed, c0p):
            a[v] = val
        for v, val in zip(self.v_c1_packed, c1p):
            a[v] = val
        for vs, vals in ((self.v_r, enc["r_signed"]),
                         (self.v_e1, enc["e1_signed"]),
                         (self.v_e2, enc["e2_signed"]),
                         (self.v_k0, enc["k0"]), (self.v_k1, enc["k1"])):
            for v, val in zip(vs, vals):
                a[v] = val % R
        if self.v_pka:
            pk_a, pk_b = self.pk_values
            for v, val in zip(self.v_pka, pk_a):
                a[v] = val % R
            for v, val in zip(self.v_pkb, pk_b):
                a[v] = val % R
        return a


def _unpack(b: CircuitBuilder, packed_vars: list, n_slots: int) -> list:
    """Decompose packed fields (PACK_WIDTH x PACK_BITS-bit slots) into slot
    lcs with full bit range checks."""
    slots = []
    for i, pv in enumerate(packed_vars):
        n_here = min(PACK_WIDTH, n_slots - i * PACK_WIDTH)
        bits = b.bits({pv: 1}, PACK_BITS * n_here)
        for s in range(n_here):
            slots.append(lc(*[
                (pow(2, j, R), bits[PACK_BITS * s + j]) for j in range(PACK_BITS)
            ]))
    assert len(slots) == n_slots
    return slots


def _byte_slots(b: CircuitBuilder, v: int) -> list:
    """254-bit decomposition -> 32 byte-slot lcs (generate_audit.py:376-396)."""
    bits = b.bits({v: 1}, 254)
    slots = []
    for i in range(32):
        terms = []
        for j in range(8):
            k = 8 * i + j
            if k < 254:
                terms.append((pow(2, j, R), bits[k]))
        slots.append(lc(*terms))
    return slots


def _range_signed(b: CircuitBuilder, v: int, bound: int = 128) -> None:
    """v in [-bound, bound]: v + bound fits in 8 bits (range_proof_signed)."""
    shifted = {v: 1, 0: bound}
    b.bits(shifted, 8)


def build_audit_circuit(pk_a: list, pk_b: list,
                        variant: str = "const_pk_e_witness",
                        ) -> AuditCircuit:
    """``variant`` selects the benchmark-harness circuit shape
    (reference ``scripts/benchmark_all.py:331-572``):

    - const_pk / var_pk: PK rows embedded as constants vs the 2n PK
      coefficients as private witnesses with in-circuit negacyclic row
      indexing (every inner-product term becomes a mul constraint).
    - e_witness / e_computed: noise terms as range-checked witnesses bound
      by the encryption identity, vs computed in-circuit as
      e = lhs - <row, r> (- Delta*msg) and then range-checked.

    """
    var_pk = variant.startswith("var_pk")
    e_computed = variant.endswith("e_computed")
    assert variant in ("const_pk_e_witness", "const_pk_e_computed",
                       "var_pk_e_witness", "var_pk_e_computed")
    b = CircuitBuilder()
    v_wa = b.public_input()
    v_ct = b.public_input()

    v_c0p = [b.private_input() for _ in range(PACKED_C0)]
    v_c1p = [b.private_input() for _ in range(PACKED_C1)]
    v_x = b.private_input()
    v_y = b.private_input()
    v_sk = b.private_input()
    v_r = [b.private_input() for _ in range(N)]
    if e_computed:
        v_e1, v_e2 = [], []
    else:
        v_e1 = [b.private_input() for _ in range(MSG_SLOTS)]
        v_e2 = [b.private_input() for _ in range(N)]
    v_k0 = [b.private_input() for _ in range(MSG_SLOTS)]
    v_k1 = [b.private_input() for _ in range(N)]
    if var_pk:
        v_pka = [b.private_input() for _ in range(N)]
        v_pkb = [b.private_input() for _ in range(N)]

    # 0. owner point derivation: sk * G == (x, y) in-circuit
    # (generate_audit.py:417-422 semantics: 128-bit lo/hi limb split)
    v_lo = b.aux(lambda w, v=v_sk: w[v] & ((1 << 128) - 1))
    v_hi = b.aux(lambda w, v=v_sk: w[v] >> 128)
    b.assert_eq({v_sk: 1}, {v_lo: 1, v_hi: pow(2, 128, R)})
    fixed_base_scalar_mul_gadget(b, {v_lo: 1}, {v_hi: 1},
                                 {v_x: 1}, {v_y: 1})

    # 1. wa_commitment = Poseidon1(x, y)
    h = b.poseidon_hash([{v_x: 1}, {v_y: 1}])
    b.assert_eq({h: 1}, {v_wa: 1})

    # 2. unpack ciphertext
    c0 = _unpack(b, v_c0p, MSG_SLOTS)
    c1 = _unpack(b, v_c1p, N)

    # 3. message byte slots
    msg = _byte_slots(b, v_x) + _byte_slots(b, v_y)

    # 4. range proofs on inputs that are witnesses
    for v in v_r + v_e1 + v_e2:
        _range_signed(b, v)

    def inner_product_lc(pk_consts, pk_vars, i):
        """<negacyclic row i, r> as an lc. const_pk: linear with constant
        coefficients; var_pk: one mul constraint per term (the reference's
        42x constraint blowup, benchmark_all.py:398-451)."""
        if not var_pk:
            row = negacyclic_matrix_row(pk_consts, i)
            return lc(*[(row[j], v_r[j]) for j in range(N)])
        acc = {}
        for j in range(N):
            idx = i - j
            if idx >= 0:
                x = {pk_vars[idx]: 1}
            else:
                # negacyclic wrap stays mod q: entry = q - pk[idx + N]
                x = {0: RLWE_Q, pk_vars[idx + N]: (-1) % R}
            t = b.mul(x, {v_r[j]: 1})
            acc[t] = (acc.get(t, 0) + 1) % R
        return acc

    def lc_sub(x, y):
        out = dict(x)
        for v, co in y.items():
            out[v] = (out.get(v, 0) - co) % R
        return out

    # 5/6. encryption identities
    # c0[i] + k0[i]*Q == <B_row_i, r> + e1[i] + Delta*msg[i]
    for i in range(MSG_SLOTS):
        rhs = inner_product_lc(pk_b, v_pkb if var_pk else None, i)
        for v, co in msg[i].items():
            rhs[v] = (rhs.get(v, 0) + DELTA * co) % R
        lhs = dict(c0[i])
        lhs[v_k0[i]] = (lhs.get(v_k0[i], 0) + RLWE_Q) % R
        if e_computed:
            # e1 = lhs - rhs, range-checked in place of the witness
            e_lc = lc_sub(lhs, rhs)
            b.bits({**e_lc, 0: (e_lc.get(0, 0) + 128) % R}, 8)
        else:
            rhs[v_e1[i]] = (rhs.get(v_e1[i], 0) + 1) % R
            b.assert_eq(lhs, rhs)
    # c1[i] + k1[i]*Q == <A_row_i, r> + e2[i]
    for i in range(N):
        rhs = inner_product_lc(pk_a, v_pka if var_pk else None, i)
        lhs = dict(c1[i])
        lhs[v_k1[i]] = (lhs.get(v_k1[i], 0) + RLWE_Q) % R
        if e_computed:
            e_lc = lc_sub(lhs, rhs)
            b.bits({**e_lc, 0: (e_lc.get(0, 0) + 128) % R}, 8)
        else:
            rhs[v_e2[i]] = (rhs.get(v_e2[i], 0) + 1) % R
            b.assert_eq(lhs, rhs)

    # 7. ct_commitment = Poseidon2 sponge over the 157 packed fields
    packed_lcs = [{v: 1} for v in v_c0p + v_c1p]
    state = [lc(0)] * 4
    full = len(packed_lcs) // 3
    for i in range(full):
        for k in range(3):
            s = dict(state[k])
            for v, co in packed_lcs[3 * i + k].items():
                s[v] = (s.get(v, 0) + co) % R
            state[k] = s
        state = b.poseidon2_permutation(state)
    rem = len(packed_lcs) - 3 * full
    for k in range(rem):
        s = dict(state[k])
        for v, co in packed_lcs[3 * full + k].items():
            s[v] = (s.get(v, 0) + co) % R
        state[k] = s
    state = b.poseidon2_permutation(state)
    b.assert_eq(state[0], {v_ct: 1})

    return AuditCircuit(b, v_wa, v_ct, v_x, v_y, v_sk, v_c0p, v_c1p,
                        v_r, v_e1, v_e2, v_k0, v_k1,
                        v_pka if var_pk else (), v_pkb if var_pk else (),
                        (tuple(pk_a), tuple(pk_b)) if var_pk else (),
                        )


def ct_commitment_of(enc: dict) -> int:
    """Host-side ct_commitment for a ciphertext record."""
    from zkbench.ref.poseidon2 import ct_commitment_ref
    packed = pack_values(enc["c0_sparse"]) + pack_values(enc["c1"])
    return ct_commitment_ref(packed)
