"""Port parity: the ACIR witness solver, the R1CS conversion and the native
witness VM (``tpu_zkpool_torch.groth16.{solver,r1cs,solver_native}``)
against their JAX counterparts, on programs both packages parse from the
same bytes (``tests/acir_cases.py``).

The withdraw program is ``scripts/withdraw_acir.py``'s (the reference's
artifact is not in the repository); its oracle is the committed withdraw
vector of ``tests/vectors.py``, whose 26 inputs must solve it to the
committed root, nullifier and wa_commitment. A tiny program with a range
check is proved on the CPU by the port's prover and held to the JAX
package's ``refimpl.groth16_ref.prove``.
"""

import gc

import numpy as np
import pytest
import torch

from tpu_zkpool.groth16 import acir as jacir
from tpu_zkpool.groth16 import r1cs as jr1cs
from tpu_zkpool.groth16 import solver as jsolver
from tpu_zkpool.groth16 import solver_native as jnative
from tpu_zkpool.refimpl import groth16_ref as jref

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.groth16 import acir, r1cs, solver, solver_native
from tpu_zkpool_torch.groth16 import prove as tp
from tpu_zkpool_torch.groth16.gadgets import _aff_dbl
from tpu_zkpool_torch.groth16.verify import verify_batch
from tpu_zkpool_torch.hash.poseidon_params import poseidon_hash_ref
from tpu_zkpool_torch.merkle import MerkleTree
from tpu_zkpool_torch.refimpl.groth16_ref import setup

import acir_cases as ac
import vectors

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def withdraw():
    """(outputs, port program, JAX program, port witness, JAX witness)."""
    wp, raw = ac.withdraw()
    prog, jprog = acir.parse_program(raw), jacir.parse_program(raw)
    ins = vectors.withdraw_inputs()
    return (wp.outputs, prog, jprog, solver.solve(prog, ins),
            jsolver.solve(jprog, ins))


def test_withdraw_solves_to_the_committed_vector(withdraw):
    out, prog, jprog, w, jw = withdraw
    assert w == jw
    assert w[out["root"]] == vectors.ROOT
    assert w[out["nullifier"]] == vectors.NULLIFIER
    assert w[out["wa_commitment"]] == vectors.WA_COMMITMENT
    assert (w[out["owner"][0]], w[out["owner"][1]]) == (vectors.OWNER_X,
                                                        vectors.OWNER_Y)
    ins = vectors.withdraw_inputs()
    trace, jtrace = [], []
    solver.solve(prog, ins, trace=trace)
    jsolver.solve(jprog, ins, trace=jtrace)
    assert ac.norm(trace) == ac.norm(jtrace)
    assert {ev[0] for ev in trace} == {"gate", "brillig", "callback"}


@pytest.mark.parametrize("field", [0, 1, 4, 10])
def test_wrong_public_or_path_raises(withdraw, field):
    """A wrong root, nullifier, wa_commitment or sibling breaks a gate."""
    _, prog, jprog, _, _ = withdraw
    bad = vectors.withdraw_inputs()
    bad[field] = (bad[field] + 1) % R
    with pytest.raises(solver.SolveError):
        solver.solve(prog, bad)
    with pytest.raises(jsolver.SolveError):
        jsolver.solve(jprog, bad)


@pytest.mark.parametrize("memory", [True, False])
def test_solvable_program_equals_jax(memory):
    raw = ac.writer.write_program(ac.solvable(memory))
    prog, jprog = acir.parse_program(raw), jacir.parse_program(raw)
    trace, jtrace = [], []
    w = solver.solve(prog, ac.SOLVABLE_INPUTS, trace=trace)
    assert w == jsolver.solve(jprog, ac.SOLVABLE_INPUTS, trace=jtrace)
    assert ac.norm(trace) == ac.norm(jtrace)
    assert 21 in w and (19 in w) == memory
    # the native path: and/xor/poseidon2 between native segments; a
    # memory read is outside the lowering, so that program falls back to
    # the interpreter
    assert solver_native.solve(prog, ac.SOLVABLE_INPUTS) == w
    if memory:
        with pytest.raises(solver_native.UnsupportedCircuit):
            solver_native.CompiledSolver(prog, ac.SOLVABLE_INPUTS)
    else:
        cs = solver_native.CompiledSolver(prog, ac.SOLVABLE_INPUTS)
        jcs = jnative.CompiledSolver(jprog, ac.SOLVABLE_INPUTS)
        assert len(cs.callbacks) == len(jcs.callbacks) == 3
        assert cs.segments == jcs.segments
        assert cs.solve(ac.SOLVABLE_INPUTS) == w


def test_convert_and_witness_equal_jax(withdraw):
    _, prog, jprog, w, _ = withdraw
    ar, jar = r1cs.convert(prog), jr1cs.convert(jprog)
    for rows, jrows in ((ar.r1cs.a_rows, jar.r1cs.a_rows),
                        (ar.r1cs.b_rows, jar.r1cs.b_rows),
                        (ar.r1cs.c_rows, jar.r1cs.c_rows)):
        assert rows == jrows
    assert (ar.r1cs.num_vars, ar.r1cs.num_public) == (
        jar.r1cs.num_vars, jar.r1cs.num_public)
    assert ar.r1cs.num_public == 6
    full = r1cs.build_witness(ar, w)
    assert full == jr1cs.build_witness(jar, w)
    assert ar.r1cs.is_satisfied(full)
    assert full[1:6] == [vectors.ROOT, vectors.NULLIFIER, vectors.RECIPIENT,
                         vectors.AMOUNT, vectors.WA_COMMITMENT]
    tampered = list(full)
    tampered[100] = (tampered[100] + 1) % R
    assert not ar.r1cs.is_satisfied(tampered)


def test_forged_owner_point_is_unsatisfiable(withdraw):
    """Soundness of the sk * G gadget (``groth16/gadgets.py``), as
    ``tests/test_groth16.py:56`` checks on the reference's artifact: a
    forged owner point (twice the real one), with every other witness
    recomputed honestly (the program without its MSM solves), leaves the
    R1CS unsatisfied."""
    out, prog, _, w, _ = withdraw
    ins, forged = ac.writer.forged_owner(ac.withdraw()[0],
                                         vectors.withdraw_inputs(), w)
    ox, oy, _ = out["owner"]
    fx, fy = _aff_dbl((w[ox], w[oy]))
    assert (ins[6], ins[7]) == (fx, fy) != (w[ox], w[oy])
    leaf = poseidon_hash_ref([fx, fy, vectors.AMOUNT, vectors.RANDOMNESS])
    assert MerkleTree.verify_proof(leaf, 0, vectors.SIBLINGS, ins[0])
    assert ins[4] == poseidon_hash_ref([fx, fy])
    assert (forged[ox], forged[oy]) == (fx, fy)
    with pytest.raises(solver.SolveError):
        solver.solve(prog, ins)                 # the MSM disagrees
    circ = prog.circuits[0]
    ar = r1cs.convert(prog)
    full = r1cs.build_witness(ar, forged)
    bad_rows = [i for i, (a, b, c) in enumerate(zip(
        ar.r1cs.a_rows, ar.r1cs.b_rows, ar.r1cs.c_rows))
        if ar.r1cs.eval_row(a, full) * ar.r1cs.eval_row(b, full) % R
        != ar.r1cs.eval_row(c, full)]
    # the MSM is the program's first opcode: its gadget's rows come first,
    # and only they fail
    msm_only = acir.Program([acir.Circuit(
        circ.name, circ.current_witness_index, circ.opcodes[:1], None,
        circ.private_parameters, circ.public_parameters, [], [])],
        prog.brillig)
    n_gadget = len(r1cs.convert(msm_only).r1cs.a_rows)
    assert bad_rows and max(bad_rows) < n_gadget


def test_compiled_solver_equals_interpreter_and_jax(withdraw):
    _, prog, jprog, w, _ = withdraw
    ins = vectors.withdraw_inputs()
    cs = solver_native.CompiledSolver(prog, ins)
    jcs = jnative.CompiledSolver(jprog, ins)
    assert cs.segments == jcs.segments == [(0, cs.segments[0][1])]
    assert not cs.callbacks                 # the MSM is a native record
    assert cs.solve(ins) == jcs.solve(ins) == w
    wit, known = cs.solve_raw(ins)
    jwit, jknown = jcs.solve_raw(ins)
    assert np.array_equal(wit, jwit) and np.array_equal(known, jknown)
    assert int(known.sum()) == len(w)
    bad = dict(ins)
    bad[0] = (bad[0] + 1) % R
    with pytest.raises(solver.SolveError):
        cs.solve(bad)
    with pytest.raises(ValueError, match="input witness set"):
        cs.solve({k: v for k, v in ins.items() if k != 25})
    assert solver_native.solve(prog, ins) == w


def test_solve_cache_holds_its_program():
    """The module cache keys on the program's id and holds the program, so
    an entry is never served to another program under a reused id."""
    small = ac.writer.write_program(ac.solvable(memory=False))
    first = acir.parse_program(small)
    want_first = solver.solve(first, ac.SOLVABLE_INPUTS)
    assert solver_native.solve(first, ac.SOLVABLE_INPUTS) == want_first
    key = (id(first), tuple(sorted(ac.SOLVABLE_INPUTS)))
    stale = solver_native._cache[key]
    del first
    gc.collect()
    other = ac.solvable(memory=False)
    gate = other.circuits[0].opcodes[-1].data["expr"]      # w20 = 3 w16
    gate.linear[1] = ((-3) % R, gate.linear[1][1])
    second = acir.parse_program(ac.writer.write_program(other))
    # plant the first program's entry under the second's id, as a reused
    # id would find it
    solver_native._cache[(id(second), key[1])] = stale
    got = solver_native.solve(second, ac.SOLVABLE_INPUTS)
    assert got == solver.solve(second, ac.SOLVABLE_INPUTS)
    assert got[20] != want_first[20]


def _tiny_program():
    """w0 = x^3 + x + 5 (public), x = w1 range-checked to 8 bits."""
    E = ac.E
    ops = [acir.Opcode("assert_zero", {"expr": E([(1, 1, 1)], [(-1, 2)])}),
           acir.Opcode("assert_zero", {"expr": E([(1, 2, 1)], [(-1, 3)])}),
           acir.Opcode("assert_zero",
                       {"expr": E(lin=[(1, 0), (-1, 3), (-1, 1)], q_c=-5)}),
           acir.Opcode("range", {"input": ("wit", 1), "bits": 8})]
    circ = acir.Circuit("main", 3, ops, None, private_parameters=[1],
                        public_parameters=[0], return_values=[],
                        assert_messages_raw=[])
    return acir.parse_program(ac.writer.write_program(
        acir.Program([circ], ac.writer.brillig_section([]))))


def test_tiny_program_proves_on_the_cpu():
    prog = _tiny_program()
    x = 201
    w_acir = solver_native.solve(prog, {0: x ** 3 + x + 5, 1: x})
    ar = r1cs.convert(prog)
    w = r1cs.build_witness(ar, w_acir)
    assert ar.r1cs.is_satisfied(w) and len(ar.r1cs.a_rows) == 3 + 9
    pk, vk = setup(ar.r1cs)
    dpk = tp.DeviceProvingKey(pk, c=8, lanes=32, device="cpu")
    proof = tp.prove(dpk, ar.r1cs, w, seed=7)
    assert proof == jref.prove(pk, ar.r1cs, w, seed=7)
    pub = w[1:ar.r1cs.num_public]
    ok = verify_batch(vk, [proof, proof], [pub, [pub[0] + 1]], device="cpu")
    assert ok.tolist() == [True, False]
    with pytest.raises(solver.SolveError, match="range"):
        solver.solve(prog, {0: 300 ** 3 + 300 + 5, 1: 300})
