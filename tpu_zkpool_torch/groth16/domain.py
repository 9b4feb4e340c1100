"""Fr-domain radix-2 NTT on int64 limbs: the prover's FFT engine (the port
of ``tpu_zkpool/groth16/domain.py``).

Values are ``int64[..., n, 16]`` Montgomery Fr limbs, transformed along axis
-2. ``forward`` is decimation in frequency (natural order in, bit-reversed
out) and ``inverse`` decimation in time (bit-reversed in, natural out), with
no bit-reversal pass between them; Fr - 1 = 2^28 * odd, generator 5. The
butterflies run limb-major (``FR.lm_*``) on whole stages at once; the JAX
package had no Pallas kernel here either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.refimpl.groth16_ref import powers

COSET_G = 5


def _root(n: int) -> int:
    assert n & (n - 1) == 0 and n <= 1 << 28
    return pow(5, (R - 1) // n, R)


@functools.lru_cache(maxsize=None)
def _tables(n: int):
    """Host tables: (forward twiddles per DIF stage, inverse twiddles per
    DIT stage, n^-1, coset powers g^i, coset inverse powers), Montgomery.
    A stage of half-width h takes the powers of omega^(n / 2h) < h; every
    stage's are every (n / 2h)-th power of omega below n / 2, so the powers
    are taken once and strided."""
    omega = _root(n)
    omega_inv = pow(omega, -1, R)
    half = max(n // 2, 1)
    pw = FR.to_mont(powers(omega, half))
    pw_inv = FR.to_mont(powers(omega_inv, half))
    fwd, inv = [], []
    h = n // 2
    while h >= 1:
        fwd.append(pw[:: n // (2 * h)])
        h //= 2
    h = 1
    while h <= n // 2:
        inv.append(pw_inv[:: n // (2 * h)])
        h *= 2
    ninv_m = FR.to_mont([pow(n, -1, R)])[0]
    coset = powers(COSET_G, n)
    coset_inv = powers(pow(COSET_G, -1, R), n)
    return fwd, inv, ninv_m, FR.to_mont(coset), FR.to_mont(coset_inv)


@functools.lru_cache(maxsize=None)
def bitrev_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


@functools.lru_cache(maxsize=None)
def _tables_on(n: int, device: str):
    fwd, inv, ninv_m, coset, coset_inv = _tables(n)

    def lm(t):   # twiddles limb-major (16, h)
        return torch.as_tensor(np.ascontiguousarray(t.T), device=device)

    return dict(
        fwd=tuple(lm(t) for t in fwd),
        inv=tuple(lm(t) for t in inv),
        ninv=torch.as_tensor(ninv_m, device=device),
        coset=torch.as_tensor(coset, device=device),
        coset_inv=torch.as_tensor(coset_inv, device=device),
        br=torch.as_tensor(bitrev_perm(n), device=device),
    )


def tables(n: int, device) -> dict:
    """All NTT / coset tables for domain size n on ``device``."""
    return _tables_on(n, str(torch.device(device)))


def _stage_view(y, tw):
    """Limb-major y (16, *lead, n) as (16, *lead, n / 2h, 2h) blocks, and
    the twiddles tw (16, h) shaped to broadcast against one half-block."""
    h = tw.shape[-1]
    n = y.shape[-1]
    blocks = y.reshape(y.shape[:-1] + (n // (2 * h), 2 * h))
    twb = tw.view((16,) + (1,) * (blocks.dim() - 2) + (h,))
    return blocks, twb, h


def forward(x: torch.Tensor, tws=None) -> torch.Tensor:
    """DIF NTT along axis -2 of int64[..., n, 16] Montgomery values."""
    n = x.shape[-2]
    if tws is None:
        tws = tables(n, x.device)["fwd"]
    y = x.movedim(-1, 0)
    for tw in tws:
        blocks, twb, h = _stage_view(y, tw)
        u, v = blocks[..., :h], blocks[..., h:]
        s = FR.lm_add(u, v)
        d = FR.lm_mul(FR.lm_sub(u, v), twb)
        y = torch.cat([s, d], -1).reshape(y.shape)
    return y.movedim(0, -1).contiguous()


def inverse(y: torch.Tensor, tws=None, ninv=None) -> torch.Tensor:
    """DIT inverse NTT (bit-reversed in, natural out), scaled by n^-1."""
    n = y.shape[-2]
    if tws is None:
        t = tables(n, y.device)
        tws, ninv = t["inv"], t["ninv"]
    x = y.movedim(-1, 0)
    for tw in tws:
        blocks, twb, h = _stage_view(x, tw)
        u = blocks[..., :h]
        v = FR.lm_mul(blocks[..., h:], twb)
        x = torch.cat([FR.lm_add(u, v), FR.lm_sub(u, v)], -1).reshape(x.shape)
    return FR.mont_mul(x.movedim(0, -1), ninv).contiguous()


def interpolate_natural(evals, br=None, tws=None, ninv=None):
    """Natural-order domain evaluations (E[i] = P(omega^i)) -> coefficients:
    the bit-reversal gather, then ``inverse``."""
    n = evals.shape[-2]
    if br is None:
        br = tables(n, evals.device)["br"]
    return inverse(evals[..., br, :], tws, ninv)


def coset_forward(coeffs, coset=None, tws=None):
    """Evaluate a coefficient vector on the coset g * omega^i (BR order)."""
    n = coeffs.shape[-2]
    if coset is None:
        coset = tables(n, coeffs.device)["coset"]
    return forward(FR.mont_mul(coeffs, coset), tws)


def coset_inverse(evals, coset_inv=None, tws=None, ninv=None):
    n = evals.shape[-2]
    if coset_inv is None:
        coset_inv = tables(n, evals.device)["coset_inv"]
    return FR.mont_mul(inverse(evals, tws, ninv), coset_inv)
