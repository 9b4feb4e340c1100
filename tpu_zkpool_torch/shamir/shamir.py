"""Shamir 2-of-3 secret sharing over BN254 Fr, batched, in torch.

The port of ``tpu_zkpool/shamir/shamir.py``. Reference semantics
(``refimpl.rlwe_ref.shamir_share_field`` / ``shamir_reconstruct_field``):
degree-(threshold - 1) polynomials evaluated at x = 1, 2, 3;
reconstruction by Lagrange interpolation at 0. Every coefficient of a key
is shared or reconstructed in one batched ``FieldCtx`` op, on the device
its tensors lie on.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_zkpool_torch.fields.fctx import FR


def _mont_const(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(FR.to_mont([v])[0], device=like.device)


def share_batch(secrets, coeffs):
    """Evaluate y_k = secret + sum_j coeffs_j * (k+1)^(j+1) for k = 0..2.

    secrets: int64[..., 16] Montgomery; coeffs: int64[T-1, ..., 16]
    Montgomery random polynomial coefficients. Returns int64[3, ..., 16]
    (threshold T = coeffs.shape[0] + 1).
    """
    n_coeffs = coeffs.shape[0]
    shares = []
    for x in (1, 2, 3):
        acc = secrets
        x_pow = x
        for j in range(n_coeffs):
            acc = FR.add(acc, FR.mont_mul(coeffs[j],
                                          _mont_const(x_pow, secrets)))
            x_pow *= x
        shares.append(acc)
    return torch.stack(shares, dim=0)


def _lagrange_at_zero(xs):
    """Host: Lagrange basis coefficients L_i(0) for points xs (ints)."""
    p = FR.modulus
    out = []
    for i, xi in enumerate(xs):
        num, den = 1, 1
        for j, xj in enumerate(xs):
            if i != j:
                num = num * (-xj) % p
                den = den * (xi - xj) % p
        out.append(num * pow(den, -1, p) % p)
    return out


def reconstruct_batch(ys, xs=(1, 2)):
    """secret = sum_i L_i(0) * y_i for shares at x-coords ``xs``.

    ys: int64[T, ..., 16] Montgomery share values. One batched op for any
    number of coefficients.
    """
    lag = _lagrange_at_zero(list(xs))
    lm = torch.as_tensor(FR.to_mont(np.asarray(lag, dtype=object)),
                         device=ys.device)
    acc = FR.mont_mul(ys[0], lm[0])
    for i in range(1, len(xs)):
        acc = FR.add(acc, FR.mont_mul(ys[i], lm[i]))
    return acc
