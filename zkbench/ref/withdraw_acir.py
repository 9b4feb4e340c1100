"""The pool's withdraw statement as an ACIR program, and its artifact
writer: a frozen copy of ``scripts/withdraw_acir.py`` for the benchmark.
The benchmark writes the artifact (``write_artifact``) that the port parses
and converts, and its reference converts the same ``Program`` with its own
frozen ``r1cs.convert``.

The statement is the one the pool's flows define (``protocol/flows.py``),
over the 26 witnesses of ``WithdrawWitness.acir_inputs()`` (public 0-4 =
root, nullifier, recipient, amount, wa_commitment; then sk, owner_x,
owner_y, randomness, index and the sibling path):

- ``(owner_x, owner_y) = sk * G`` on the embedded curve, through the
  ``multi_scalar_mul`` blackbox with the generator and ``(lo, hi) =
  (sk, 0)`` as constant inputs (the form ``groth16.r1cs.convert`` binds
  with its fixed-base gadget), its output asserted equal to the inputs;
- ``wa_commitment = H(owner_x, owner_y)``, ``nullifier = H(sk, index)``;
- ``commitment = H(owner_x, owner_y, amount, randomness)``, the leaf;
- the index's bits from the ``directive_to_le_radix`` brillig call, each
  held by ``b * b = b`` and their weighted sum by ``= index``;
- a path of ``H(left, right)``, bit i putting the node on the right, as
  ``merkle.tree.MerkleTree.verify_proof`` walks it, ending at ``root``;
- ``recipient * recipient`` into a witness of its own, so the recipient
  enters the proof's rows (a public input in no row would not be bound
  by the proof).

``H`` is circom Poseidon (``hash.poseidon_params.poseidon_hash_ref``)
written out as ``AssertZero`` gates: per S-box ``x^2``, ``x^4`` and
``x^5``, per round the MDS mix, one new witness each. There is no
Poseidon blackbox in ACIR: a BN254 Poseidon compiles to arithmetic gates.
"""

from __future__ import annotations

import base64
import gzip
import json
import struct
from typing import NamedTuple

from zkbench.ref.bn254 import (
    EMBEDDED_GX, EMBEDDED_GY, FR_MOD as P)
from zkbench.ref.acir import (
    _BLACKBOX, Circuit, Expression, Opcode, Program)
from zkbench.ref.poseidon_params import (
    N_ROUNDS_F, N_ROUNDS_P, poseidon_constants)

# ------------------------------------------------------------- the writer

_BLACKBOX_TAG = {name: tag for tag, name in _BLACKBOX.items()}


def _u8(v: int) -> bytes:
    return struct.pack("<B", v)


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def _field(v: int) -> bytes:
    """A field element: u64 length, then big-endian bytes of minimal
    length (zero is the empty vector)."""
    b = v.to_bytes((v.bit_length() + 7) // 8, "big")
    return _u64(len(b)) + b


def _string(s: str) -> bytes:
    b = s.encode()
    return _u64(len(b)) + b


def _expr(e) -> bytes:
    out = [_u64(len(e.mul_terms))]
    out += [_field(c) + _u32(a) + _u32(b) for c, a, b in e.mul_terms]
    out.append(_u64(len(e.linear)))
    out += [_field(c) + _u32(a) for c, a in e.linear]
    out.append(_field(e.q_c))
    return b"".join(out)


def _input(fi) -> bytes:
    kind, v = fi
    if kind == "const":
        return _u32(0) + _field(v)
    if kind == "wit":
        return _u32(1) + _u32(v)
    raise ValueError(f"function input kind {kind!r}")


def _inputs(fis) -> bytes:
    return _u64(len(fis)) + b"".join(_input(fi) for fi in fis)


def _blackbox(op) -> bytes:
    d = op.data
    head = _u32(1) + _u32(_BLACKBOX_TAG[op.kind])
    if op.kind == "range":
        return head + _input(d["input"]) + _u32(d["bits"])
    if op.kind in ("and", "xor"):
        return (head + _input(d["lhs"]) + _u32(d["lbits"]) + _input(d["rhs"])
                + _u32(d["rbits"]) + _u32(d["out"]))
    if op.kind == "multi_scalar_mul":
        return (head + _inputs(d["points"]) + _inputs(d["scalars"])
                + _input(d["predicate"]) + b"".join(map(_u32, d["out"])))
    if op.kind == "embedded_curve_add":
        return (head + b"".join(map(_input, d["in"]))
                + _input(d["predicate"]) + b"".join(map(_u32, d["out"])))
    if op.kind == "poseidon2_permutation":
        return (head + _inputs(d["inputs"]) + _u64(len(d["outputs"]))
                + b"".join(map(_u32, d["outputs"])))
    raise ValueError(f"blackbox {op.kind!r}")


def _brillig_call(d) -> bytes:
    out = [_u32(4), _u32(d["id"]), _u64(len(d["inputs"]))]
    for kind, payload in d["inputs"]:
        if kind == "single":
            out.append(_u32(0) + _expr(payload))
        elif kind == "array":
            out.append(_u32(1) + _u64(len(payload))
                       + b"".join(map(_expr, payload)))
        elif kind == "memory":
            out.append(_u32(2) + _u32(payload))
        else:
            raise ValueError(f"brillig input kind {kind!r}")
    out.append(_u64(len(d["outputs"])))
    for kind, tgt in d["outputs"]:
        if kind == "simple":
            out.append(_u32(0) + _u32(tgt))
        elif kind == "array":
            out.append(_u32(1) + _u64(len(tgt)) + b"".join(map(_u32, tgt)))
        else:
            raise ValueError(f"brillig output kind {kind!r}")
    pred = d["predicate"]
    out.append(_u8(0) if pred is None else _u8(1) + _expr(pred))
    return b"".join(out)


def _opcode(op) -> bytes:
    d = op.data
    if op.kind == "assert_zero":
        return _u32(0) + _expr(d["expr"])
    if op.kind == "memory_op":
        return (_u32(2) + _u32(d["block"]) + _expr(d["op"])
                + _expr(d["index"]) + _expr(d["value"]))
    if op.kind == "memory_init":
        btag, bdata = d["type"]
        return (_u32(3) + _u32(d["block"]) + _u64(len(d["init"]))
                + b"".join(map(_u32, d["init"])) + _u32(btag)
                + (_u32(bdata) if btag == 1 else b""))
    if op.kind == "brillig_call":
        return _brillig_call(d)
    return _blackbox(op)


def _assert_message(msg) -> bytes:
    loc, sel, items = msg
    if loc[0] == "acir":
        out = [_u32(0) + _u64(loc[1])]
    elif loc[0] == "brillig":
        out = [_u32(1) + _u64(loc[1]) + _u64(loc[2])]
    else:
        raise ValueError(f"opcode location {loc!r}")
    out.append(_u64(sel) + _u64(len(items)))
    for kind, payload in items:
        if kind == "expr":
            out.append(_u32(0) + _expr(payload))
        elif kind == "mem":
            out.append(_u32(1) + _u32(payload))
        else:
            raise ValueError(f"assertion payload kind {kind!r}")
    return b"".join(out)


def _witnesses(ws) -> bytes:
    ws = list(ws or ())
    return _u64(len(ws)) + b"".join(map(_u32, ws))


def _circuit(c) -> bytes:
    return b"".join([
        _string(c.name), _u32(c.current_witness_index),
        _u64(len(c.opcodes)), *map(_opcode, c.opcodes),
        _witnesses(c.private_parameters), _witnesses(c.public_parameters),
        _witnesses(c.return_values),
        _u64(len(c.assert_messages_raw or ())),
        *map(_assert_message, c.assert_messages_raw or ())])


def write_program(program) -> bytes:
    """bincode bytes that ``parse_program`` reads back into ``program``:
    any object with the ``Program`` / ``Circuit`` / ``Opcode`` /
    ``Expression`` fields. The brillig section (``program.brillig``, raw
    bytes as the parser keeps them) is written as it is."""
    return (_u64(len(program.circuits))
            + b"".join(map(_circuit, program.circuits)) + program.brillig)


def brillig_section(names) -> bytes:
    """A brillig section of the named functions with empty bodies, in the
    order ``solver.brillig_function_names`` finds them (each name must be
    a distinct ``directive_...``; a call's ``id`` indexes this list)."""
    return _u64(len(names)) + b"".join(_string(n) + _u64(0) for n in names)


def write_artifact(path: str, program, abi: dict) -> str:
    """A nargo-style artifact: ``{"abi", "bytecode"}``, the bytecode
    base64(gzip(``write_program``))."""
    raw = gzip.compress(write_program(program), mtime=0)
    with open(path, "w") as f:
        json.dump({"abi": abi, "bytecode": base64.b64encode(raw).decode()},
                  f)
    return path


# ---------------------------------------------------- the withdraw program

class _Gates:
    """Emits ``AssertZero`` gates over fresh witnesses from ``first``. A
    value is affine in one witness, (w, a, b) = a * w + b (w None: the
    constant b)."""

    def __init__(self, first: int):
        self.next = first
        self.ops: list = []

    def new(self) -> int:
        self.next += 1
        return self.next - 1

    def gate(self, mul=(), lin=(), q_c=0):
        mul = [(c % P, a, b) for c, a, b in mul if c % P]
        lin = [(c % P, w) for c, w in lin if c % P]
        self.ops.append(Opcode("assert_zero",
                               {"expr": Expression(mul, lin, q_c % P)}))

    def equal(self, x: int, y: int):
        self.gate(lin=[(1, x), (-1, y)])

    def pow5(self, s: tuple) -> tuple:
        w, a, b = s
        if w is None:
            return (None, 0, pow(b, 5, P))
        y1, y2, y3 = self.new(), self.new(), self.new()
        self.gate([(a * a, w, w)], [(2 * a * b, w), (-1, y1)], b * b)
        self.gate([(1, y1, y1)], [(-1, y2)])
        self.gate([(a, y2, w)], [(b, y2), (-1, y3)])
        return (y3, 1, 0)

    def mix(self, row, state) -> tuple:
        z = self.new()
        lin = [(m * a, w) for m, (w, a, _) in zip(row, state) if w is not None]
        q_c = sum(m * b for m, (_, _, b) in zip(row, state))
        self.gate(lin=lin + [(-1, z)], q_c=q_c)
        return (z, 1, 0)

    def poseidon(self, inputs) -> int:
        """circom Poseidon of the witnesses ``inputs``: state = [0, *inputs];
        each round adds its constants, S-boxes (all in a full round, the
        first in a partial one) and mixes; the output is state[0] (the
        last round mixes that row only)."""
        t = len(inputs) + 1
        C, M = poseidon_constants(t)
        r_f, r_p = N_ROUNDS_F, N_ROUNDS_P[t - 2]
        state = [(None, 0, 0)] + [(w, 1, 0) for w in inputs]
        for r in range(r_f + r_p):
            state = [(w, a, b + C[r * t + i])
                     for i, (w, a, b) in enumerate(state)]
            full = r < r_f // 2 or r >= r_f // 2 + r_p
            state = [self.pow5(s) if full or i == 0 else s
                     for i, s in enumerate(state)]
            rows = M if r < r_f + r_p - 1 else M[:1]
            state = [self.mix(row, state) for row in rows]
        return state[0][0]


class WithdrawProgram(NamedTuple):
    program: Program
    abi: dict
    # witness indices of what the program computes: "root", "nullifier",
    # "wa_commitment", "commitment", "owner" (the MSM's (x, y, infinity))
    outputs: dict


N_PUBLIC = 5
_NAMES = ("root", "nullifier", "recipient", "amount", "wa_commitment",
          "secret_key", "owner_x", "owner_y", "randomness", "index")


def withdraw_abi(depth: int) -> dict:
    field = {"kind": "field"}
    params = [{"name": n, "type": field,
               "visibility": "public" if i < N_PUBLIC else "private"}
              for i, n in enumerate(_NAMES)]
    params[_NAMES.index("index")]["type"] = {
        "kind": "integer", "sign": "unsigned", "width": depth}
    params.append({"name": "siblings", "visibility": "private", "type": {
        "kind": "array", "length": depth, "type": field}})
    return {"parameters": params, "return_type": None, "error_types": {}}


def withdraw_program(depth: int = 16) -> WithdrawProgram:
    """The withdraw statement (module docstring) as one ACIR circuit over
    the inputs ``WithdrawWitness.acir_inputs()`` numbers 0 .. 9 + depth."""
    root, nul, rcpt, amount, wa, sk, ox, oy, rnd, index = range(10)
    sibs = list(range(10, 10 + depth))
    g = _Gates(10 + depth)

    owner = (g.new(), g.new(), g.new())
    g.ops.append(Opcode("multi_scalar_mul", {
        "points": [("const", EMBEDDED_GX), ("const", EMBEDDED_GY),
                   ("const", 0)],
        "scalars": [("wit", sk), ("const", 0)],
        "predicate": ("const", 1), "out": owner}))
    g.equal(owner[0], ox)
    g.equal(owner[1], oy)
    g.gate(lin=[(1, owner[2])])                  # not the point at infinity

    wa_out = g.poseidon([ox, oy])
    g.equal(wa_out, wa)
    nul_out = g.poseidon([sk, index])
    g.equal(nul_out, nul)
    leaf = g.poseidon([ox, oy, amount, rnd])

    bits = [g.new() for _ in range(depth)]
    g.ops.append(Opcode("brillig_call", {
        "id": 0,
        "inputs": [("single", Expression([], [(1, index)], 0)),
                   ("single", Expression([], [], 2))],
        "outputs": [("array", bits)], "predicate": None}))
    for b in bits:
        g.gate([(1, b, b)], [(-1, b)])
    g.gate(lin=[(1 << i, b) for i, b in enumerate(bits)] + [(-1, index)])

    cur = leaf
    for b, sib in zip(bits, sibs):
        left, right = g.new(), g.new()
        # left = cur + b (sib - cur), right = cur + sib - left
        g.gate([(1, b, sib), (-1, b, cur)], [(1, cur), (-1, left)])
        g.gate(lin=[(1, cur), (1, sib), (-1, left), (-1, right)])
        cur = g.poseidon([left, right])
    g.equal(cur, root)

    g.gate([(1, rcpt, rcpt)], [(-1, g.new())])

    circ = Circuit(
        "main", g.next - 1, g.ops, None,
        private_parameters=list(range(N_PUBLIC, 10 + depth)),
        public_parameters=list(range(N_PUBLIC)), return_values=[],
        assert_messages_raw=[])
    program = Program([circ], brillig_section(["directive_to_le_radix"]))
    return WithdrawProgram(program, withdraw_abi(depth), {
        "root": cur, "nullifier": nul_out, "wa_commitment": wa_out,
        "commitment": leaf, "owner": owner})
