"""ACIR programs for the port's parity tests, built with the port's
structures and written by ``scripts/withdraw_acir.py`` (loaded here by
path), so that both packages can parse the same bytes.

- ``withdraw()``: the depth-16 withdraw program (cached), its bytes and its
  output witnesses;
- ``every_opcode()``: a program with every opcode and field the parser
  reads (not solvable: its brillig call takes array and memory inputs);
- ``solvable(memory=True)``: gates (one deferred), a range check, and/xor,
  the invert and integer-quotient directives, the MSM and curve-add
  blackboxes, a Poseidon2 permutation and, with ``memory``, a memory
  block written and read;
- ``norm(x)``: a structure of either package as plain tuples, so that the
  two packages' dataclasses compare.
"""

import dataclasses
import functools
import importlib.util
import os

from tpu_zkpool_torch.fields.bn254 import EMBEDDED_GX, EMBEDDED_GY
from tpu_zkpool_torch.fields.bn254 import FR_MOD as P
from tpu_zkpool_torch.groth16.acir import (Circuit, Expression, Opcode,
                                           Program)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_writer():
    spec = importlib.util.spec_from_file_location(
        "withdraw_acir", os.path.join(_ROOT, "scripts", "withdraw_acir.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


writer = _load_writer()


@functools.lru_cache(maxsize=None)
def withdraw():
    """(WithdrawProgram, its bincode bytes) at depth 16."""
    wp = writer.withdraw_program(16)
    return wp, writer.write_program(wp.program)


def E(mul=(), lin=(), q_c=0):
    return Expression([(c % P, a, b) for c, a, b in mul],
                      [(c % P, w) for c, w in lin], q_c % P)


def _circuit(name, cwi, ops, public=(0,), messages=()):
    return Circuit(name, cwi, ops, None, private_parameters=[1, 2],
                   public_parameters=list(public), return_values=[cwi],
                   assert_messages_raw=list(messages))


def every_opcode() -> Program:
    gen = [("const", EMBEDDED_GX), ("const", EMBEDDED_GY), ("const", 0)]
    ops = [
        Opcode("assert_zero", {"expr": E([(3, 1, 2)], [(1, 0), (-1, 3)], 5)}),
        Opcode("range", {"input": ("wit", 0), "bits": 8}),
        Opcode("and", {"lhs": ("wit", 0), "lbits": 8,
                       "rhs": ("const", 0x0F), "rbits": 8, "out": 4}),
        Opcode("xor", {"lhs": ("wit", 1), "lbits": 32, "rhs": ("wit", 0),
                       "rbits": 32, "out": 5}),
        Opcode("multi_scalar_mul", {
            "points": gen, "scalars": [("wit", 2), ("const", 0)],
            "predicate": ("const", 1), "out": (6, 7, 8)}),
        Opcode("embedded_curve_add", {
            "in": [("wit", 6), ("wit", 7), ("wit", 8)] + gen,
            "predicate": ("const", 1), "out": (9, 10, 11)}),
        Opcode("poseidon2_permutation", {
            "inputs": [("wit", 0), ("wit", 1), ("wit", 3), ("const", P - 1)],
            "outputs": [12, 13, 14, 15]}),
        Opcode("memory_init", {"block": 0, "init": [0, 1, 15],
                               "type": (0, None)}),
        Opcode("memory_init", {"block": 1, "init": [2], "type": (1, 7)}),
        Opcode("memory_op", {"block": 0, "op": E(q_c=1), "index": E(q_c=1),
                             "value": E(lin=[(1, 16)])}),
        Opcode("brillig_call", {
            "id": 1,
            "inputs": [("single", E(lin=[(1, 3)])),
                       ("array", [E(lin=[(2, 4)], q_c=1), E(q_c=0)]),
                       ("memory", 0)],
            "outputs": [("simple", 17), ("array", [18, 19])],
            "predicate": E(q_c=1)}),
        Opcode("brillig_call", {"id": 0, "inputs": [], "outputs": [],
                                "predicate": None}),
    ]
    messages = [(("acir", 3), 0xDEADBEEF,
                 [("expr", E([(1, 1, 1)], [(5, 2)], 7)), ("mem", 0)]),
                (("brillig", 10, 2), 7, [])]
    second = _circuit("helper", 1, [Opcode("assert_zero",
                                           {"expr": E(lin=[(1, 0), (-1, 1)])})],
                      public=(), messages=())
    return Program([_circuit("main", 19, ops, messages=messages), second],
                   writer.brillig_section(["directive_invert",
                                           "directive_integer_quotient"]))


def solvable(memory: bool = True) -> Program:
    """Inputs 0 (a), 1 (b), 2 (a small scalar); see the module docstring."""
    gen = [("const", EMBEDDED_GX), ("const", EMBEDDED_GY), ("const", 0)]
    ops = [
        Opcode("assert_zero", {"expr": E([(1, 0, 1)], [(2, 0), (-1, 3)], 1)}),
        Opcode("range", {"input": ("wit", 0), "bits": 8}),
        Opcode("and", {"lhs": ("wit", 0), "lbits": 8,
                       "rhs": ("const", 0x0F), "rbits": 8, "out": 4}),
        Opcode("xor", {"lhs": ("wit", 1), "lbits": 8, "rhs": ("wit", 0),
                       "rbits": 8, "out": 5}),
        Opcode("brillig_call", {"id": 0, "inputs": [("single", E(lin=[(1, 3)]))],
                                "outputs": [("simple", 6)], "predicate": None}),
        Opcode("assert_zero", {"expr": E([(1, 3, 6)], q_c=-1)}),
        Opcode("brillig_call", {
            "id": 1, "inputs": [("single", E(lin=[(1, 3)])),
                                ("single", E(q_c=4))],
            "outputs": [("simple", 7), ("simple", 8)], "predicate": None}),
        Opcode("assert_zero", {"expr": E(lin=[(4, 7), (1, 8), (-1, 3)])}),
        Opcode("multi_scalar_mul", {
            "points": gen, "scalars": [("wit", 2), ("const", 0)],
            "predicate": ("const", 1), "out": (9, 10, 11)}),
        Opcode("embedded_curve_add", {
            "in": [("wit", 9), ("wit", 10), ("wit", 11)] + gen,
            "predicate": ("const", 1), "out": (12, 13, 14)}),
        Opcode("poseidon2_permutation", {
            "inputs": [("wit", 0), ("wit", 1), ("wit", 3), ("const", 9)],
            "outputs": [15, 16, 17, 18]}),
    ]
    src = 16
    if memory:
        ops += [
            Opcode("memory_init", {"block": 0, "init": [0, 1, 15],
                                   "type": (0, None)}),
            Opcode("memory_op", {"block": 0, "op": E(q_c=1),
                                 "index": E(q_c=1), "value": E(lin=[(1, 16)])}),
            Opcode("memory_op", {"block": 0, "op": E(q_c=0),
                                 "index": E(q_c=1), "value": E(lin=[(1, 19)])}),
            Opcode("assert_zero", {"expr": E(lin=[(1, 19), (-1, 16)])}),
        ]
        src = 19
    ops += [
        # two unknowns: deferred until the next gate solves w20
        Opcode("assert_zero", {"expr": E(lin=[(1, 21), (-1, 20)], q_c=-1)}),
        Opcode("assert_zero", {"expr": E(lin=[(1, 20), (-2, src)])}),
    ]
    circ = Circuit("main", 21, ops, None, private_parameters=[1, 2],
                   public_parameters=[0], return_values=[],
                   assert_messages_raw=[])
    return Program([circ], writer.brillig_section(
        ["directive_invert", "directive_integer_quotient"]))


SOLVABLE_INPUTS = {0: 0x35, 1: 0x1234, 2: 0x1F2E3D4C5B6A7988}


def norm(x):
    """Dataclasses of either package -> (class name, fields), recursively;
    lists and tuples -> tuples; dicts -> sorted item tuples."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            norm(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted(((k, norm(v)) for k, v in x.items()),
                            key=lambda kv: repr(kv[0])))
    return x
