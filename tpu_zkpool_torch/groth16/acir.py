"""Parser for Noir ACIR artifacts (bincode serialization).

The port's copy of ``tpu_zkpool/groth16/acir.py`` (host code): the same
structures from the same bytes. The reference repo commits a compiled
withdraw circuit at ``noir_circuit/target/shielded_pool_verifier.json``
whose ``bytecode`` field is base64(gzip(bincode(Program))). This module
decodes that program; ``solver`` solves it for an input assignment (the
host-side witness generator of the Groth16 prover, SURVEY.md §7.1 L4) and
``r1cs`` converts it for the prover.

Format notes (reverse-engineered from the committed artifact, bincode legacy
config): Vec lengths are u64 LE, enum variant tags are u32 LE, field elements
are length-prefixed 32-byte big-endian blobs, witnesses are u32 LE.

Malformed bytes raise ``ValueError`` (the JAX module asserts).
"""

from __future__ import annotations

import base64
import gzip
import json
from dataclasses import dataclass, field as dfield


class Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.off : self.off + n]
        if len(b) != n:
            raise ValueError(f"unexpected EOF at {self.off}")
        self.off += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def field(self) -> int:
        # FieldElement is serialized as Vec<u8> (big-endian, minimal length —
        # zero encodes as the empty vec).
        n = self.u64()
        if n > 32:
            raise ValueError(f"field length {n} at {self.off}")
        return int.from_bytes(self.take(n), "big")

    def string(self) -> str:
        n = self.u64()
        return self.take(n).decode()


@dataclass
class Expression:
    """q_c + sum(c*w) + sum(c*w1*w2) (an ACIR AssertZero / operand expression)."""

    mul_terms: list  # [(coeff, w1, w2)]
    linear: list     # [(coeff, w)]
    q_c: int


@dataclass
class Opcode:
    kind: str
    data: dict


@dataclass
class Circuit:
    name: str
    current_witness_index: int
    opcodes: list
    expression_width: object
    private_parameters: list
    public_parameters: list
    return_values: list
    assert_messages_raw: object = None


@dataclass
class Program:
    circuits: list
    brillig: list  # raw (unparsed bodies)


def _parse_expression(c: Cursor) -> Expression:
    n_mul = c.u64()
    mul_terms = []
    for _ in range(n_mul):
        coeff = c.field()
        w1 = c.u32()
        w2 = c.u32()
        mul_terms.append((coeff, w1, w2))
    n_lin = c.u64()
    linear = []
    for _ in range(n_lin):
        coeff = c.field()
        w = c.u32()
        linear.append((coeff, w))
    q_c = c.field()
    return Expression(mul_terms, linear, q_c)


def _parse_function_input(c: Cursor):
    tag = c.u32()
    if tag == 0:  # Constant
        return ("const", c.field())
    elif tag == 1:  # Witness
        return ("wit", c.u32())
    raise ValueError(f"FunctionInput tag {tag} at {c.off}")


# BlackBox function variant order in this artifact's ACIR version. Only the
# ones that actually occur in the reference artifacts are mapped; others raise
# so we notice immediately.
_BLACKBOX = {
    0: "aes128_encrypt",
    1: "and",
    2: "xor",
    3: "range",
    4: "blake2s",
    5: "blake3",
    6: "ecdsa_secp256k1",
    7: "ecdsa_secp256r1",
    8: "multi_scalar_mul",
    9: "embedded_curve_add",
    10: "keccakf1600",
    11: "recursive_aggregation",
    12: "bigint_add",
    13: "bigint_sub",
    14: "bigint_mul",
    15: "bigint_div",
    16: "bigint_from_le_bytes",
    17: "bigint_to_le_bytes",
    18: "poseidon2_permutation",
    19: "sha256_compression",
}


def parse_program(raw: bytes, debug: bool = False) -> Program:
    c = Cursor(raw)
    n_funcs = c.u64()
    circuits = []
    for _ in range(n_funcs):
        name = c.string()
        cwi = c.u32()
        n_ops = c.u64()
        if debug:
            print(f"circuit {name!r}: cwi={cwi} n_ops={n_ops} at {c.off}")
        opcodes = []
        for k in range(n_ops):
            opcodes.append(_parse_opcode(c, debug=debug, idx=k))
        # Trailer fields parsed permissively.
        circuits.append(
            Circuit(name, cwi, opcodes, None, None, None, None)
        )
        _parse_circuit_trailer(c, circuits[-1], debug=debug)
    brillig = _parse_brillig_section(c, debug=debug)
    return Program(circuits, brillig)


def _parse_opcode(c: Cursor, debug=False, idx=None) -> Opcode:
    tag = c.u32()
    if tag == 0:  # AssertZero
        return Opcode("assert_zero", {"expr": _parse_expression(c)})
    if tag == 1:  # BlackBoxFuncCall
        return _parse_blackbox_full(c)
    if tag == 2:  # MemoryOp
        block_id = c.u32()
        op = _parse_expression(c)
        index = _parse_expression(c)
        value = _parse_expression(c)
        return Opcode("memory_op", {"block": block_id, "op": op, "index": index, "value": value})
    if tag == 3:  # MemoryInit
        block_id = c.u32()
        n = c.u64()
        init = [c.u32() for _ in range(n)]
        btag = c.u32()
        bdata = c.u32() if btag == 1 else None
        return Opcode("memory_init", {"block": block_id, "init": init, "type": (btag, bdata)})
    if tag == 4:  # BrilligCall
        bid = c.u32()
        n_in = c.u64()
        inputs = []
        for _ in range(n_in):
            itag = c.u32()
            if itag == 0:  # Single(Expression)
                inputs.append(("single", _parse_expression(c)))
            elif itag == 1:  # Array(Vec<Expression>)
                m = c.u64()
                inputs.append(("array", [_parse_expression(c) for _ in range(m)]))
            elif itag == 2:  # MemoryArray(BlockId)
                inputs.append(("memory", c.u32()))
            else:
                raise ValueError(f"brillig input tag {itag} at {c.off}")
        n_out = c.u64()
        outputs = []
        for _ in range(n_out):
            otag = c.u32()
            if otag == 0:
                outputs.append(("simple", c.u32()))
            elif otag == 1:
                m = c.u64()
                outputs.append(("array", [c.u32() for _ in range(m)]))
            else:
                raise ValueError(f"brillig output tag {otag} at {c.off}")
        ptag = c.u8()  # bincode Option<..> is a single byte
        predicate = _parse_expression(c) if ptag == 1 else None
        return Opcode("brillig_call", {"id": bid, "inputs": inputs, "outputs": outputs, "predicate": predicate})
    if tag == 5:  # Call
        raise NotImplementedError(f"acir Call opcode at {c.off}")
    raise ValueError(f"opcode tag {tag} at offset {c.off} (op #{idx})")


def _parse_blackbox_full(c: Cursor) -> Opcode:
    tag = c.u32()
    name = _BLACKBOX.get(tag, f"bb{tag}")
    if name == "range":
        inp = _parse_function_input(c)
        bits = c.u32()
        return Opcode("range", {"input": inp, "bits": bits})
    if name == "and" or name == "xor":
        lhs = _parse_function_input(c)
        lbits = c.u32()
        rhs = _parse_function_input(c)
        rbits = c.u32()
        out = c.u32()
        return Opcode(name, {"lhs": lhs, "lbits": lbits, "rhs": rhs, "rbits": rbits, "out": out})
    if name == "multi_scalar_mul":
        n = c.u64()
        points = [_parse_function_input(c) for _ in range(n)]
        m = c.u64()
        scalars = [_parse_function_input(c) for _ in range(m)]
        predicate = _parse_function_input(c)  # observed Constant(1) in artifacts
        outputs = (c.u32(), c.u32(), c.u32())
        return Opcode("multi_scalar_mul", {"points": points, "scalars": scalars,
                                           "predicate": predicate, "out": outputs})
    if name == "embedded_curve_add":
        ins = [_parse_function_input(c) for _ in range(6)]
        predicate = _parse_function_input(c)
        outputs = (c.u32(), c.u32(), c.u32())
        return Opcode("embedded_curve_add", {"in": ins, "predicate": predicate, "out": outputs})
    if name == "poseidon2_permutation":
        n = c.u64()
        inputs = [_parse_function_input(c) for _ in range(n)]
        m = c.u64()
        outputs = [c.u32() for _ in range(m)]
        return Opcode("poseidon2_permutation", {"inputs": inputs, "outputs": outputs})
    raise NotImplementedError(f"blackbox {name} at {c.off}")


def _parse_circuit_trailer(c: Cursor, circ: Circuit, debug=False):
    """parameter sets, return values, assert messages."""
    n = c.u64()
    circ.private_parameters = [c.u32() for _ in range(n)]
    n = c.u64()
    circ.public_parameters = [c.u32() for _ in range(n)]
    n = c.u64()
    circ.return_values = [c.u32() for _ in range(n)]
    n = c.u64()
    msgs = []
    for _ in range(n):
        # (OpcodeLocation, AssertionPayload) — parse permissively and keep raw.
        msgs.append(_parse_assert_message(c))
    circ.assert_messages_raw = msgs


def _parse_assert_message(c: Cursor):
    # OpcodeLocation enum {0: Acir(u64)? , 1: Brillig{acir_index,brillig_index}}
    tag = c.u32()
    if tag == 0:
        loc = ("acir", c.u64())
    elif tag == 1:
        loc = ("brillig", c.u64(), c.u64())
    else:
        raise ValueError(f"opcode location tag {tag} at {c.off}")
    # AssertionPayload { error_selector: u64, payload: Vec<ExpressionOrMemory> }
    sel = c.u64()
    n = c.u64()
    items = []
    for _ in range(n):
        etag = c.u32()
        if etag == 0:
            items.append(("expr", _parse_expression(c)))
        elif etag == 1:
            items.append(("mem", c.u32()))
        else:
            raise ValueError(f"payload expr tag {etag} at {c.off}")
    return (loc, sel, items)


def _parse_brillig_section(c: Cursor, debug=False):
    """Brillig function bodies — kept raw (solver uses gate semantics instead)."""
    rest = c.buf[c.off :]
    return rest


def load_artifact(path: str) -> tuple:
    """Load a nargo .json artifact -> (abi dict, Program)."""
    with open(path) as f:
        art = json.load(f)
    raw = gzip.decompress(base64.b64decode(art["bytecode"]))
    return art["abi"], parse_program(raw)
