"""Port parity: the circuit frontend (``tpu_zkpool_torch.groth16.builder``,
``gadgets``) and the audit circuit (``protocol.audit_circuit``) against
``tpu_zkpool``'s, and a small committed circuit from the port's builder
proved and verified by the port on the CPU.

- ``build_audit_circuit(a, b, variant)`` over ``rlwe_ref.keygen(42)``'s
  key equals JAX's row for row (A, B and C rows, ``num_vars``,
  ``num_public``, ``committed``) for ``const_pk_e_witness`` and
  ``const_pk_e_computed``, with and without ``logderiv`` (24,070, 71,361,
  22,982 and 70,273 rows);
- the non-logderiv witness of owner 0's encryption (``encrypt(seed=999)``)
  equals JAX's and satisfies the R1CS, for both const-PK variants (e as a
  witness, e computed in the circuit);
- with ``RUN_SLOW=1``, the two var-PK circuits (1,185,473 and 1,184,385
  rows) hash alike in both packages (``cache.circuit_hash``);
- a committed circuit of ~300 rows (``range_value`` on two committed wires
  and one ``poseidon2_permutation``) is set up, solved by
  ``witness_committed``, proved by the port's ``prove`` (c = 8, 32 lanes,
  on the CPU), verified by ``verify_batch`` on the CPU, and a wrong public
  input is rejected.
"""

import functools
import os

import pytest
import torch

from tpu_zkpool.protocol import audit_circuit as jac

from tpu_zkpool_torch.groth16 import prove as tp
from tpu_zkpool_torch.groth16 import verify as tv
from tpu_zkpool_torch.groth16.builder import CircuitBuilder
from tpu_zkpool_torch.hash import poseidon2
from tpu_zkpool_torch.hash.poseidon_params import poseidon_hash_ref
from tpu_zkpool_torch.protocol import audit_circuit as ac
from tpu_zkpool_torch.refimpl import curve_ref, rlwe_ref
from tpu_zkpool_torch.refimpl.groth16_ref import setup, verify

torch.set_num_threads(1)

SECRET_KEY = 0x43F5147FE5A665DF7600DA3AE1C0AE1C
OWNER_X = 0x13C1A5D58F3CE2659C8CB9F6686264197864954B53A3BA1EDA4168B9B18927B8
OWNER_Y = 0x1D1E2A6A28D810BC04992F6E8F890F1D9CAD471819BC111AE229B507F4D77A0F


@functools.lru_cache(maxsize=None)
def _key():
    return rlwe_ref.keygen(42)


@functools.lru_cache(maxsize=None)
def _circuits(logderiv, variant="const_pk_e_witness"):
    kg = _key()
    return (ac.build_audit_circuit(kg["a"], kg["b"], variant, logderiv),
            jac.build_audit_circuit(kg["a"], kg["b"], variant, logderiv))


@pytest.mark.parametrize("logderiv,rows,variant", [
    pytest.param(True, 24070, "const_pk_e_witness", id="True-24070"),
    pytest.param(False, 71361, "const_pk_e_witness", id="False-71361"),
    pytest.param(True, 22982, "const_pk_e_computed", id="True-22982"),
    pytest.param(False, 70273, "const_pk_e_computed", id="False-70273")])
def test_audit_r1cs_equals_jax(logderiv, rows, variant):
    port, jax_c = _circuits(logderiv, variant)
    a, b = port.builder.r1cs(), jax_c.builder.r1cs()
    assert len(a.a_rows) == rows
    assert (a.num_vars, a.num_public) == (b.num_vars, b.num_public)
    assert a.a_rows == b.a_rows and a.b_rows == b.b_rows
    assert a.c_rows == b.c_rows
    assert port.committed == jax_c.committed
    assert (port.v_wa, port.v_ct, port.v_challenge) == (
        jax_c.v_wa, jax_c.v_ct, jax_c.v_challenge)
    if logderiv:
        assert len(port.committed) == 6785
        assert a.num_vars == rows + 6784


def test_owner_point_and_witness_equal_jax():
    assert curve_ref.scalar_mul(SECRET_KEY) == (OWNER_X, OWNER_Y)
    _witness_equals_jax("const_pk_e_witness")


def test_e_computed_witness_equals_jax():
    """e computed in the circuit (e = lhs - <row, r>): its witness carries
    the computed noise and its bit decompositions."""
    _witness_equals_jax("const_pk_e_computed")


def _witness_equals_jax(variant):
    port, jax_c = _circuits(False, variant)
    kg = _key()
    enc = rlwe_ref.encrypt(kg["a"], kg["b"], OWNER_X, OWNER_Y, seed=999)
    wa = poseidon_hash_ref([OWNER_X, OWNER_Y])
    ct = ac.ct_commitment_of(enc)
    assert ct == jac.ct_commitment_of(enc)
    args = (OWNER_X, OWNER_Y, enc, wa, ct, SECRET_KEY)
    w = port.builder.witness(port.assignment(*args))
    assert w == jax_c.builder.witness(jax_c.assignment(*args))
    assert port.builder.r1cs().is_satisfied(w)


@pytest.mark.skipif(os.environ.get("RUN_SLOW") != "1",
                    reason="builds two 1.2M-row circuits in each package, "
                           "~2 min (RUN_SLOW=1)")
@pytest.mark.parametrize("variant,rows", [("var_pk_e_witness", 1185473),
                                          ("var_pk_e_computed", 1184385)])
def test_var_pk_circuit_hash_equals_jax(variant, rows):
    from tpu_zkpool.groth16.cache import circuit_hash as jhash

    from tpu_zkpool_torch.groth16.cache import circuit_hash
    kg = _key()
    port = ac.build_audit_circuit(kg["a"], kg["b"], variant)
    jax_c = jac.build_audit_circuit(kg["a"], kg["b"], variant)
    a, b = port.builder.r1cs(), jax_c.builder.r1cs()
    assert len(a.a_rows) == rows
    assert circuit_hash(a) == jhash(b)


def _small_committed():
    """out = Poseidon2(x)[0] of four private words, two of them range
    checked to 4 bits by the committed log-derivative table."""
    b = CircuitBuilder()
    v_out = b.public_input()
    v_ch = b.public_input()
    xs = [b.private_input() for _ in range(4)]
    for v in xs[:2]:
        b.commit_wire(v)
        b.range_value({v: 1}, 4)
    s = b.poseidon2_permutation([{v: 1} for v in xs])
    b.assert_eq(s[0], {v_out: 1})
    committed = b.finalize_range_checks(v_ch)
    return b, v_out, v_ch, xs, committed


def test_small_committed_circuit_proves_and_verifies():
    b, v_out, v_ch, xs, committed = _small_committed()
    r1cs = b.r1cs()
    assert 250 <= len(r1cs.a_rows) <= 350
    pk, vk = setup(r1cs, committed=committed)
    vals = [5, 11, 123456789, 2**200 + 7]
    out = poseidon2.permutation_ref(vals)[0]
    w = b.witness_committed({v_out: out, **dict(zip(xs, vals))}, v_ch, pk)
    assert r1cs.is_satisfied(w)
    dpk = tp.DeviceProvingKey(pk, c=8, lanes=32, device="cpu")
    proof = tp.prove(dpk, r1cs, w, seed=3)
    assert len(proof) == 5 and verify(vk, proof, [out])
    got = tv.verify_batch(vk, [proof, proof], [[out], [out + 1]],
                          device="cpu")
    assert list(got) == [True, False]
