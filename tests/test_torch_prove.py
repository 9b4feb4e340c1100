"""Port parity: the Groth16 device prover of ``tpu_zkpool_torch`` against
``tpu_zkpool.refimpl.groth16_ref.prove`` (the stated oracle of the JAX
device prover) on the tiny circuit of ``tests/test_prove_tpu.py``.

On the CPU the MSM kernels run as their plain twins (with ``tree=True`` the
G1 legs run the affine tree's twin); ``c = 8`` and 32 lanes
keep a proof to ~20 s (full scalars need c >= 8: at most 32 windows).
``prove_batch`` is held to ``prove`` in ``test_torch_prove_committed.py``.
"""

import torch

from tpu_zkpool.refimpl import groth16_ref as jref

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.groth16 import prove as tp
from tpu_zkpool_torch.refimpl.groth16_ref import R1CS, setup, verify

torch.set_num_threads(1)


def _tiny_circuit():
    return R1CS(num_vars=5, num_public=2,
                a_rows=[{2: 1}, {3: 1}, {}],
                b_rows=[{2: 1}, {2: 1}, {0: 1}],
                c_rows=[{3: 1}, {4: 1},
                        {1: 1, 4: -1 % R, 2: -1 % R, 0: -5 % R}])


def test_prove_matches_reference():
    r1cs = _tiny_circuit()
    pk, vk = setup(r1cs)
    dpk = tp.DeviceProvingKey(pk, c=8, lanes=32, device="cpu")
    x = 3
    w = [1, x**3 + x + 5, x, x * x, x**3]
    proof = tp.prove(dpk, r1cs, w, seed=7)
    assert proof == jref.prove(pk, r1cs, w, seed=7)
    assert verify(vk, proof, [w[1]])
    assert not verify(vk, proof, [w[1] + 1])


def test_prove_tree_matches_reference():
    """``tree=True``: the four G1 legs run through the affine bucket tree
    (K8's plain twin here), the G2 leg through the prefix path."""
    r1cs = _tiny_circuit()
    pk, vk = setup(r1cs)
    dpk = tp.DeviceProvingKey(pk, c=8, lanes=32, tree=True, device="cpu")
    x = 5
    w = [1, x**3 + x + 5, x, x * x, x**3]
    proof = tp.prove(dpk, r1cs, w, seed=7)
    assert proof == jref.prove(pk, r1cs, w, seed=7)
    assert verify(vk, proof, [w[1]])
    assert not verify(vk, proof, [w[1] + 1])
