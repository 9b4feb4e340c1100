"""Port parity: ``prove_batch`` of the device prover on a circuit with a
gnark-style Pedersen commitment (the circuit of ``tests/test_groth16.py``).

Proof i of the batch must equal ``tpu_zkpool.refimpl.groth16_ref.prove`` at
``seed + i``, which ``test_torch_prove.py`` holds equal to the port's
``prove``; so proof i equals ``prove(seed + i)``.
"""

import torch

from tpu_zkpool.refimpl import groth16_ref as jref

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.groth16 import prove as tp
from tpu_zkpool_torch.refimpl import pairing_ref as pr
from tpu_zkpool_torch.refimpl import pedersen
from tpu_zkpool_torch.refimpl.groth16_ref import G1_GEN, R1CS, setup, verify

torch.set_num_threads(1)


def test_prove_batch_committed_matches_reference():
    # out = x^3 + x + 5 and u = t * x, with t the commitment-hash public
    # input (last public). vars [1, out, t, x, x2, x3, u].
    r1cs = R1CS(
        num_vars=7, num_public=3,
        a_rows=[{3: 1}, {4: 1}, {}, {2: 1}],
        b_rows=[{3: 1}, {3: 1}, {0: 1}, {3: 1}],
        c_rows=[{4: 1}, {5: 1}, {1: 1, 5: -1 % R, 3: -1 % R, 0: -5 % R},
                {6: 1}],
    )
    pk, vk = setup(r1cs, committed=(3,))

    def witness(x):
        cm, pok = pedersen.commit(list(pk.basis), list(pk.basis_exp_sigma),
                                  [x])
        t = pedersen.commitment_to_field(cm)
        w = [1, x**3 + x + 5, t, x, x * x, x**3, t * x % R]
        assert r1cs.is_satisfied(w)
        return w, cm, pok

    ws = [witness(3), witness(4)]
    dpk = tp.DeviceProvingKey(pk, c=8, lanes=32, device="cpu")
    proofs = tp.prove_batch(dpk, r1cs, [w for w, _, _ in ws], seed=11)
    for i, (proof, (w, cm, pok)) in enumerate(zip(proofs, ws)):
        assert proof == jref.prove(pk, r1cs, w, seed=11 + i)
        assert proof[3] == cm and proof[4] == pok
        assert verify(vk, proof, [w[1]])
    A, B2, C, cm2, pok2 = proofs[0]
    w = ws[0][0]
    assert not verify(vk, (A, B2, C, cm2, pr.g1_add(pok2, G1_GEN)), [w[1]])
    assert not verify(vk, (A, B2, C), [w[1]])
    assert not verify(vk, proofs[1], [w[1]])
