"""ACIR witness solver — host-side witness generation for the Groth16 prover.

The port's copy of ``tpu_zkpool/groth16/solver.py`` (host code): the same
witness and the same resolution trace from the same program and inputs.
The ``poseidon2_permutation`` blackbox runs the port's
``hash.poseidon2.permutation_ref``, the embedded-curve ones its
``refimpl.curve_ref``.

Executes a parsed ACIR circuit (``groth16.acir``) over BN254 Fr,
solving AssertZero gates forward and dispatching brillig directives / blackbox
calls to native Python implementations. This replaces the reference's
``nargo execute`` step (``client/proof.helper.ts:55``) for the committed
withdraw circuit.
"""

from __future__ import annotations

from tpu_zkpool_torch.fields.bn254 import FR_MOD as P
from tpu_zkpool_torch.refimpl import curve_ref
from tpu_zkpool_torch.groth16.acir import Expression, Opcode, Program


class SolveError(RuntimeError):
    pass


def _eval_known(expr: Expression, w: dict) -> int | None:
    """Evaluate fully-known expression, or None if any witness unknown."""
    total = expr.q_c
    for c, a, b in expr.mul_terms:
        if a not in w or b not in w:
            return None
        total += c * w[a] * w[b]
    for c, a in expr.linear:
        if a not in w:
            return None
        total += c * w[a]
    return total % P


def _solve_gate(expr: Expression, w: dict) -> tuple | None:
    """Try to solve an AssertZero for a single unknown witness.

    Returns (witness, value) on success, None if 0 unknowns and satisfied,
    raises SolveError if unsatisfied, or returns "defer" if underdetermined.
    """
    known = expr.q_c
    unknown_coeff: dict[int, int] = {}
    for c, a, b in expr.mul_terms:
        ka, kb = a in w, b in w
        if ka and kb:
            known += c * w[a] * w[b]
        elif ka:
            unknown_coeff[b] = (unknown_coeff.get(b, 0) + c * w[a]) % P
        elif kb:
            unknown_coeff[a] = (unknown_coeff.get(a, 0) + c * w[b]) % P
        else:
            return "defer"
    for c, a in expr.linear:
        if a in w:
            known += c * w[a]
        else:
            unknown_coeff[a] = (unknown_coeff.get(a, 0) + c) % P
    known %= P
    unknown_coeff = {k: v for k, v in unknown_coeff.items() if v != 0}
    if not unknown_coeff:
        if known != 0:
            raise SolveError(f"unsatisfied gate, residual {known}")
        return None
    if len(unknown_coeff) > 1:
        return "defer"
    (wit, coeff), = unknown_coeff.items()
    val = (-known) * pow(coeff, -1, P) % P
    return (wit, val)


def _brillig_dispatch(name: str, inputs: list, outputs: list, w: dict):
    """Implement the three nargo directives by semantics."""
    if name == "directive_integer_quotient":
        a, b = inputs
        q, r = divmod(a, b)
        _assign_outputs(outputs, [q, r], w)
    elif name == "directive_invert":
        (x,) = inputs
        _assign_outputs(outputs, [pow(x, -1, P) if x % P else 0], w)
    elif name in ("directive_to_le_radix", "directive_to_radix"):
        val, radix, *_ = inputs
        outs = outputs[0][1]  # single array output
        digits = []
        v = val
        for _ in range(len(outs)):
            digits.append(v % radix)
            v //= radix
        _assign_outputs(outputs, [digits], w)
    else:
        raise SolveError(f"unknown brillig directive {name}")


def _assign_outputs(outputs, values, w):
    if len(outputs) != len(values):
        raise SolveError(f"{len(outputs)} brillig outputs for "
                         f"{len(values)} values")
    for (kind, tgt), val in zip(outputs, values):
        if kind == "simple":
            w[tgt] = val % P
        else:
            if len(tgt) != len(val):
                raise SolveError(f"{len(tgt)} array outputs for "
                                 f"{len(val)} values")
            for t, v in zip(tgt, val):
                w[t] = v % P


def _fi_value(fi, w):
    kind, v = fi
    if kind == "const":
        return v
    if v not in w:
        raise SolveError(f"blackbox input witness {v} unknown")
    return w[v]


def _exec_blackbox(op, w):
    """Execute a value-level blackbox op against witness mapping ``w``
    (dict or any mutable int->int mapping). Shared by the pure-Python
    solver and the native-replay path (solver_native.py)."""
    d = op.data
    if op.kind == "multi_scalar_mul":
        pts = [_fi_value(fi, w) for fi in d["points"]]
        scs = [_fi_value(fi, w) for fi in d["scalars"]]
        acc = None
        for i in range(0, len(pts), 3):
            x, y, inf = pts[i : i + 3]
            lo, hi = scs[2 * (i // 3) : 2 * (i // 3) + 2]
            scalar = lo + (hi << 128)
            pt = None if inf else (x, y)
            acc = curve_ref.add(acc, curve_ref.scalar_mul(scalar, pt))
        ox, oy, oinf = d["out"]
        if acc is None:
            w[ox], w[oy], w[oinf] = 0, 0, 1
        else:
            w[ox], w[oy], w[oinf] = acc[0], acc[1], 0
    elif op.kind in ("and", "xor"):
        a = _fi_value(d["lhs"], w)
        bvv = _fi_value(d["rhs"], w)
        w[d["out"]] = (a & bvv) if op.kind == "and" else (a ^ bvv)
    elif op.kind == "embedded_curve_add":
        vals = [_fi_value(fi, w) for fi in d["in"]]
        x1, y1, i1, x2, y2, i2 = vals
        p1 = None if i1 else (x1, y1)
        p2 = None if i2 else (x2, y2)
        acc = curve_ref.add(p1, p2)
        ox, oy, oinf = d["out"]
        if acc is None:
            w[ox], w[oy], w[oinf] = 0, 0, 1
        else:
            w[ox], w[oy], w[oinf] = acc[0], acc[1], 0
    elif op.kind == "poseidon2_permutation":
        from tpu_zkpool_torch.hash.poseidon2 import permutation_ref
        state = [_fi_value(fi, w) for fi in d["inputs"]]
        out = permutation_ref(state)
        for ov, val in zip(d["outputs"], out):
            w[ov] = val
    else:
        raise SolveError(f"not a blackbox opcode: {op.kind}")


def solve(program: Program, inputs: dict[int, int], brillig_names=None,
          check_asserts: bool = True, trace: list | None = None
          ) -> dict[int, int]:
    """Solve the main circuit's witness vector given input assignments.

    ``inputs`` maps witness index -> value. Returns the full witness dict.

    ``trace`` (optional list) records the RESOLUTION schedule — the order
    in which gates solved/checked, brillig directives fired, and blackbox
    ops ran. The schedule depends only on the set of input witness
    indices, not their values, so one traced run compiles the circuit
    into the native replay program (``solver_native.py``).
    """
    circ = program.circuits[0]
    if brillig_names is None:
        brillig_names = brillig_function_names(program)
    w = {k: v % P for k, v in inputs.items()}
    pending: list[Expression] = []
    memory: dict[int, list] = {}

    def rec(*ev):
        if trace is not None:
            trace.append(ev)

    def drain_pending():
        progress = True
        while progress and pending:
            progress = False
            for expr in list(pending):
                res = _solve_gate(expr, w)
                if res == "defer":
                    continue
                pending.remove(expr)
                progress = True
                if res is not None:
                    w[res[0]] = res[1]
                rec("gate", expr, None if res is None else res[0])

    for k, op in enumerate(circ.opcodes):
        if op.kind == "assert_zero":
            res = _solve_gate(op.data["expr"], w)
            if res == "defer":
                pending.append(op.data["expr"])
            elif res is not None:
                rec("gate", op.data["expr"], res[0])
                w[res[0]] = res[1]
                drain_pending()
            else:
                rec("gate", op.data["expr"], None)
        elif op.kind == "range":
            if check_asserts:
                kind, v = op.data["input"]
                if kind == "wit" and v in w:
                    rec("range", v, op.data["bits"])
                    if w[v] >= 1 << op.data["bits"]:
                        raise SolveError(
                            f"range check failed at op {k}: w{v} >= 2^{op.data['bits']}")
        elif op.kind == "brillig_call":
            d = op.data
            vals = []
            payloads = []
            for kind, payload in d["inputs"]:
                if kind == "single":
                    v = _eval_known(payload, w)
                    if v is None:
                        raise SolveError(f"brillig input unknown at op {k}")
                    vals.append(v)
                    payloads.append(payload)
                else:
                    raise SolveError(f"brillig input kind {kind} at op {k}")
            name = brillig_names[d["id"]]
            rec("brillig", name, payloads, d["outputs"])
            _brillig_dispatch(name, vals, d["outputs"], w)
            drain_pending()
        elif op.kind in ("multi_scalar_mul", "and", "xor",
                         "embedded_curve_add", "poseidon2_permutation"):
            rec("callback", op)
            _exec_blackbox(op, w)
            drain_pending()
        elif op.kind == "memory_init":
            d = op.data
            vals = []
            for wit in d["init"]:
                if wit not in w:
                    raise SolveError(f"memory_init witness w{wit} unknown at {k}")
                vals.append(w[wit])
            memory[d["block"]] = vals
        elif op.kind == "memory_op":
            d = op.data
            opv = _eval_known(d["op"], w)
            idx = _eval_known(d["index"], w)
            if opv is None or idx is None:
                raise SolveError(f"memory_op selector/index unknown at {k}")
            block = memory.get(d["block"])
            if block is None:
                raise SolveError(f"memory block {d['block']} uninitialized at {k}")
            if opv == 1:  # write
                val = _eval_known(d["value"], w)
                if val is None:
                    raise SolveError(f"memory write value unknown at {k}")
                block[idx] = val
            else:         # read: assign the single unknown in the value expr
                res = block[idx]
                expr = d["value"]
                unknown = [(c0, v) for c0, v in expr.linear if v not in w]
                if not unknown:
                    if _eval_known(expr, w) != res:
                        raise SolveError(f"memory read mismatch at {k}")
                elif len(unknown) == 1 and not expr.mul_terms:
                    c0, v = unknown[0]
                    known = sum(c * w[vv] for c, vv in expr.linear
                                if vv in w) + expr.q_c
                    w[v] = (res - known) * pow(c0 % P, -1, P) % P
                else:
                    raise SolveError(f"memory read expr too complex at {k}")
            drain_pending()
        else:
            raise SolveError(f"unhandled opcode {op.kind} at {k}")

    drain_pending()
    if pending:
        raise SolveError(f"{len(pending)} gates left unsolved")
    return w


def brillig_function_names(program: Program) -> list[str]:
    """Extract the brillig function name list (bodies are not needed —
    the solver reimplements the directives natively)."""
    from tpu_zkpool_torch.groth16.acir import Cursor

    c = Cursor(program.brillig)
    n = c.u64()
    names = []
    # Names are length-prefixed strings followed by opaque bodies; scan for
    # the next plausible string by searching for the following name prefix.
    # Simpler: the three directives are known; locate each by substring.
    blob = program.brillig
    import re

    for m in re.finditer(rb"directive_[a-z_0-9]+", blob):
        names.append(m.group(0).decode())
    # Preserve order of first appearance, dedupe.
    seen = []
    for x in names:
        if x not in seen:
            seen.append(x)
    return seen
