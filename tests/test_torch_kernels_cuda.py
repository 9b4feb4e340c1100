"""The CUDA kernels (grid MSM K1-K6, Poseidon K7, affine tree K8, the NTT
exchange butterfly K9, the pairing kernels P1 and P2, Poseidon2 P3, the
H(X) kernels P4 and P5) against their plain torch twins, on the card.

Marked ``cuda``: it needs an NVIDIA GPU with the CUDA toolkit (nvcc) and
skips elsewhere. Run it there with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda -n 0``;
``python3 chip_smoke.py`` runs the same check and more.
"""

import pytest
import torch


@pytest.mark.cuda
def test_kernels_equal_plain_twins():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke
    errs = chip_smoke.check_kernels(torch.device("cuda", 0), lanes=256, k=3,
                                    W=3, wlanes=16, B=40, pairs=1500)
    # 34 modes (K1 2, K2 at 4 step counts x 3 modes, K3 at 4 step counts,
    # K4 plain and in 7 gathered modes, K5 at s = 0, 1 and 7, K6 on 5
    # planted window sets) x (Fp, Fp2); K7 at the 16 widths
    # t = 2 .. 17 in lanes and at t = 2 .. 12 one thread a hash, and for
    # t = 2, 3, 5, 17 at the 6 batches of POSEIDON_BS in the wrapper's
    # layout; K8 complete and incomplete at M = 1 once a planted kind (9),
    # M = 40, 1,023, 1,025, the prover's level 0 and 1,500
    assert len(errs) == 68 + 16 + 11 + 4 * 6 + 2 * (9 + 5)
    assert not {k: v for k, v in errs.items() if v}


@pytest.mark.cuda
def test_exchange_butterfly_equals_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke
    errs, launches = chip_smoke.check_exchange(torch.device("cuda", 0),
                                               B=40, S=200)
    # one shard: forward and inverse x u = 0, 1 x (random tw, R mod q);
    # whole stages, one launch each: 3 shapes x D = 2, 4, 8 x forward and
    # inverse x rdma and ppermute
    assert len(errs) == 8 + 3 * 3 * 2 * 2 and launches == len(errs)
    assert not {k: v for k, v in errs.items() if v}


@pytest.mark.cuda
def test_pairing_kernels_equal_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke
    errs, _, _ = chip_smoke.check_pairing(torch.device("cuda", 0), B=40)
    # P1: 3 legs (two fixed) at B = 40, 1, 4, 33 and 2 batched legs at
    # B = 1, 4, 33; P2 on P1's 3-leg outputs at the same four batches, on
    # its 2-leg output and on random values with 1 and 0 planted
    assert len(errs) == 4 + 3 + 4 + 1 + 1
    assert not {k: v for k, v in errs.items() if v}


@pytest.mark.cuda
def test_poseidon2_kernel_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke
    errs, _ = chip_smoke.check_poseidon2(torch.device("cuda", 0),
                                         Bs=(1, 2, 33, 40), ns=(0, 1, 4, 7))
    # the permutation at 4 batches, the sponge at 4 batches x 4 lengths,
    # the bb vector
    assert len(errs) == 4 + 4 * 4 + 1
    assert not {k: v for k, v in errs.items() if v}


@pytest.mark.cuda
def test_fr_ntt_kernels_equal_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    import chip_smoke
    errs, pass_launches, want_launches = chip_smoke.check_fr_ntt(
        torch.device("cuda", 0), small=6, row=12, big=12)
    # P4: every (h_first, count) of n = 2 .. 64 (56 passes), both
    # directions, x P = 1, 3 x 9 modes; at 2^12 the plan's 6 + 6 passes in
    # 3 DIF / 5 DIT fused modes and single stages at both ends (5 + 7
    # cases); two whole 2^12 transforms of 2 passes; P5: times R^2 and 1,
    # each also in place, at 2 element counts
    n_small = 56 * 2 * 2 * 9
    assert len(errs) == n_small + 12 + 2 + 2 * 2 * 2
    assert pass_launches == want_launches == n_small + 12 + 2 * 2
    assert not {k: v for k, v in errs.items() if v}
