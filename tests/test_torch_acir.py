"""Port parity: the ACIR parser (``tpu_zkpool_torch.groth16.acir``) against
``tpu_zkpool.groth16.acir`` on the same bytes.

The reference's withdraw artifact is not in the repository, so the bytes
come from ``scripts/withdraw_acir.py``: its ``write_program`` is the
inverse of ``parse_program`` (checked here: bytes -> structure -> the same
bytes), over the depth-16 withdraw program and a program with every opcode
and field the parser reads (``tests/acir_cases.py``).
"""

import base64
import gzip
import json

import pytest

from tpu_zkpool.groth16 import acir as jacir
from tpu_zkpool.groth16 import solver as jsolver

from tpu_zkpool_torch.groth16 import acir, solver

import acir_cases as ac


@pytest.mark.parametrize("case", ["withdraw", "every_opcode"])
def test_parse_equals_jax_and_round_trips(case):
    if case == "withdraw":
        program, raw = ac.withdraw()[0].program, ac.withdraw()[1]
    else:
        program = ac.every_opcode()
        raw = ac.writer.write_program(program)
    got, want = acir.parse_program(raw), jacir.parse_program(raw)
    assert ac.norm(got) == ac.norm(want) == ac.norm(program)
    assert ac.writer.write_program(got) == raw
    assert (solver.brillig_function_names(got)
            == jsolver.brillig_function_names(want))


def test_every_opcode_is_read():
    """The case program reaches every branch of the opcode reader."""
    got = acir.parse_program(ac.writer.write_program(ac.every_opcode()))
    main, helper = got.circuits
    kinds = {op.kind for op in main.opcodes}
    assert kinds == {"assert_zero", "range", "and", "xor", "multi_scalar_mul",
                     "embedded_curve_add", "poseidon2_permutation",
                     "memory_init", "memory_op", "brillig_call"}
    call = next(op for op in main.opcodes if op.kind == "brillig_call")
    assert [k for k, _ in call.data["inputs"]] == ["single", "array", "memory"]
    assert [k for k, _ in call.data["outputs"]] == ["simple", "array"]
    assert call.data["predicate"] is not None
    assert [m[0][0] for m in main.assert_messages_raw] == ["acir", "brillig"]
    assert [k for k, _ in main.assert_messages_raw[0][2]] == ["expr", "mem"]
    assert {op.data["type"] for op in main.opcodes
            if op.kind == "memory_init"} == {(0, None), (1, 7)}
    assert helper.name == "helper" and len(helper.opcodes) == 1
    assert solver.brillig_function_names(got) == [
        "directive_invert", "directive_integer_quotient"]


def test_load_artifact_round_trip(tmp_path):
    wp, raw = ac.withdraw()
    path = ac.writer.write_artifact(str(tmp_path / "w.json"), wp.program,
                                    wp.abi)
    abi, got = acir.load_artifact(path)
    jabi, want = jacir.load_artifact(path)
    assert abi == jabi == wp.abi
    assert ac.norm(got) == ac.norm(want)
    with open(path) as f:
        art = json.load(f)
    assert gzip.decompress(base64.b64decode(art["bytecode"])) == raw
    circ = got.circuits[0]
    assert circ.public_parameters == [0, 1, 2, 3, 4]
    assert circ.private_parameters == list(range(5, 26))
    names = [p["name"] for p in abi["parameters"]]
    assert names[:5] == ["root", "nullifier", "recipient", "amount",
                         "wa_commitment"]


@pytest.mark.parametrize("cut", ["half", "last"])
def test_truncated_bytes_raise(cut):
    """Bytes cut inside the circuits (the brillig section after them is
    kept raw, unparsed) raise in both packages."""
    program = ac.every_opcode()
    raw = ac.writer.write_program(program)
    end = len(raw) - len(program.brillig)
    short = raw[:end // 2 if cut == "half" else end - 1]
    with pytest.raises(ValueError, match="EOF"):
        acir.parse_program(short)
    with pytest.raises(AssertionError, match="EOF"):
        jacir.parse_program(short)


def test_bad_tags_raise():
    raw = bytearray(ac.writer.write_program(ac.every_opcode()))
    # the first opcode's tag follows n_funcs (8), the name (8 + 4), the
    # witness index (4) and n_ops (8)
    off = 8 + 8 + 4 + 4 + 8
    assert raw[off:off + 4] == b"\x00\x00\x00\x00"
    raw[off] = 9
    for parse in (acir.parse_program, jacir.parse_program):
        with pytest.raises(ValueError, match="opcode tag 9"):
            parse(bytes(raw))
