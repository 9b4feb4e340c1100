"""Port parity: ``tpu_zkpool_torch.groth16.verify.verify_batch`` on the CPU
(the pairing kernels' plain versions) against
``refimpl.groth16_ref.verify``, proof by proof, exact: valid proofs,
corrupted ones (a public input, a swapped C, a foreign A), a B point that
meets a zero denominator in the host line walk (the zero-norm guard), and
a committed batch (the proof-of-knowledge pairing) with a tampered PoK.

The proofs come from the host ``tpu_zkpool.refimpl.groth16_ref.prove`` on
tiny circuits. A plain three-leg pairing costs ~4 s on a CPU at any small
batch, so each batch is verified once.
"""

import numpy as np
import pytest
import torch

from tpu_zkpool.refimpl import groth16_ref as jref

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.groth16 import verify as tv
from tpu_zkpool_torch.refimpl import pairing_ref as pr
from tpu_zkpool_torch.refimpl import pedersen
from tpu_zkpool_torch.refimpl.groth16_ref import R1CS, setup, verify

torch.set_num_threads(1)


def _ref(vk, proof, pub):
    """refimpl's verify; its Miller loop raises on a zero denominator
    (pow(0, -1, p)), which is a rejection."""
    try:
        return verify(vk, proof, pub)
    except ValueError:
        return False


def _cubic():
    # out = x^3 + x + 5, vars [1, out, x, x2, x3]
    return R1CS(num_vars=5, num_public=2,
                a_rows=[{2: 1}, {3: 1}, {}],
                b_rows=[{2: 1}, {2: 1}, {0: 1}],
                c_rows=[{3: 1}, {4: 1},
                        {1: 1, 4: -1 % R, 2: -1 % R, 0: -5 % R}])


def test_verify_batch_matches_reference():
    r1cs = _cubic()
    pk, vk = setup(r1cs, seed=17)
    ws = [[1, (x ** 3 + x + 5) % R, x, x * x % R, x ** 3 % R]
          for x in (3, 4, 5)]
    proofs = [jref.prove(pk, r1cs, w, seed=20 + i) for i, w in enumerate(ws)]
    pubs = [[w[1]] for w in ws]
    batch, bpubs = list(proofs), [list(p) for p in pubs]
    # 3: a corrupted public input; 4: a swapped C; 5: a foreign A; 6: a B
    # with y = 0 (a zero denominator at the first doubling line); 7: valid
    batch += [proofs[0], (proofs[1][0], proofs[1][1], proofs[2][2]),
              (proofs[0][0], proofs[2][1], proofs[2][2]),
              (proofs[1][0], (proofs[1][1][0], (0, 0)), proofs[1][2]),
              proofs[2]]
    bpubs += [[pubs[0][0] + 1], pubs[1], pubs[2], pubs[1], pubs[2]]
    t = {}
    got = tv.verify_batch(vk, batch, bpubs, device="cpu", timings=t)
    want = [_ref(vk, p, x) for p, x in zip(batch, bpubs)]
    assert isinstance(got, np.ndarray) and got.dtype == bool
    assert got.tolist() == want == [True] * 3 + [False] * 4 + [True]
    assert set(t) == {"vk", "l_pub", "b_lines", "b_pack", "g1", "device"}
    # the per-VK precompute is cached (one entry a VK and device)
    assert tv._vk_fixed(vk, torch.device("cpu")) is \
        tv._vk_fixed(vk, torch.device("cpu"))


def test_verify_batch_committed_matches_reference():
    # out = x^3 + x + 5 and u = t * x, with t the commitment-hash public
    # input (last public). vars [1, out, t, x, x2, x3, u].
    r1cs = R1CS(num_vars=7, num_public=3,
                a_rows=[{3: 1}, {4: 1}, {}, {2: 1}],
                b_rows=[{3: 1}, {3: 1}, {0: 1}, {3: 1}],
                c_rows=[{4: 1}, {5: 1},
                        {1: 1, 5: -1 % R, 3: -1 % R, 0: -5 % R}, {6: 1}])
    pk, vk = setup(r1cs, seed=19, committed=(3,))
    proofs, pubs = [], []
    for i, x in enumerate((3, 4, 6)):
        cm, _ = pedersen.commit(list(pk.basis), list(pk.basis_exp_sigma),
                                [x])
        t = pedersen.commitment_to_field(cm)
        w = [1, (x ** 3 + x + 5) % R, t, x, x * x % R, x ** 3 % R,
             t * x % R]
        proofs.append(jref.prove(pk, r1cs, w, seed=30 + i))
        pubs.append([w[1]])
    A, B2, C, cm, pok = proofs[1]
    batch = proofs + [(A, B2, C, cm, pr.g1_add(pok, (1, 2)))]
    bpubs = pubs + [pubs[1]]
    got = tv.verify_batch(vk, batch, bpubs, device="cpu")
    want = [_ref(vk, p, x) for p, x in zip(batch, bpubs)]
    assert got.tolist() == want == [True, True, True, False]
    with pytest.raises(AssertionError, match="mixed commitment batch"):
        tv.verify_batch(vk, [proofs[0], proofs[1][:3]], pubs[:2],
                        device="cpu")
