"""Port parity: the circuit frontend (``tpu_zkpool_torch.groth16.builder``,
``gadgets``) and the audit circuit (``protocol.audit_circuit``) against
``tpu_zkpool``'s, and a small committed circuit from the port's builder
proved and verified by the port on the CPU.

- ``build_audit_circuit(a, b, "const_pk_e_witness")`` over
  ``rlwe_ref.keygen(42)``'s key equals JAX's row for row (A, B and C rows,
  ``num_vars``, ``num_public``, ``committed``), with and without
  ``logderiv`` (24,070 and 71,361 rows);
- the non-logderiv witness of owner 0's encryption (``encrypt(seed=999)``)
  equals JAX's and satisfies the R1CS;
- a committed circuit of ~300 rows (``range_value`` on two committed wires
  and one ``poseidon2_permutation``) is set up, solved by
  ``witness_committed``, proved by the port's ``prove`` (c = 8, 32 lanes,
  on the CPU), verified by ``verify_batch`` on the CPU, and a wrong public
  input is rejected.
"""

import functools

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
def _circuits(logderiv):
    kg = _key()
    return (ac.build_audit_circuit(kg["a"], kg["b"], "const_pk_e_witness",
                                   logderiv),
            jac.build_audit_circuit(kg["a"], kg["b"], "const_pk_e_witness",
                                    logderiv))


@pytest.mark.parametrize("logderiv,rows", [(True, 24070), (False, 71361)])
def test_audit_r1cs_equals_jax(logderiv, rows):
    port, jax_c = _circuits(logderiv)
    a, b = port.builder.r1cs(), jax_c.builder.r1cs()
    assert len(a.a_rows) == rows
    assert (a.num_vars, a.num_public) == (b.num_vars, b.num_public)
    assert a.a_rows == b.a_rows and a.b_rows == b.b_rows
    assert a.c_rows == b.c_rows
    assert port.committed == jax_c.committed
    assert (port.v_wa, port.v_ct, port.v_challenge) == (
        jax_c.v_wa, jax_c.v_ct, jax_c.v_challenge)
    if logderiv:
        assert len(port.committed) == 6785 and a.num_vars == 30854


def test_owner_point_and_witness_equal_jax():
    assert curve_ref.scalar_mul(SECRET_KEY) == (OWNER_X, OWNER_Y)
    port, jax_c = _circuits(False)
    kg = _key()
    enc = rlwe_ref.encrypt(kg["a"], kg["b"], OWNER_X, OWNER_Y, seed=999)
    wa = poseidon_hash_ref([OWNER_X, OWNER_Y])
    ct = ac.ct_commitment_of(enc)
    assert ct == jac.ct_commitment_of(enc)
    args = (OWNER_X, OWNER_Y, enc, wa, ct, SECRET_KEY)
    w = port.builder.witness(port.assignment(*args))
    assert w == jax_c.builder.witness(jax_c.assignment(*args))
    assert port.builder.r1cs().is_satisfied(w)


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
