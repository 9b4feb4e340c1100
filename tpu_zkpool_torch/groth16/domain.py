"""Fr-domain radix-2 NTT on int64 limbs: the prover's FFT engine (the port
of ``tpu_zkpool/groth16/domain.py``).

Values are ``int64[..., n, 16]`` Montgomery Fr limbs, transformed along axis
-2. ``forward`` is decimation in frequency (natural order in, bit-reversed
out) and ``inverse`` decimation in time (bit-reversed in, natural out), with
no bit-reversal pass between them; Fr - 1 = 2^28 * odd, generator 5.

The public functions send a CPU tensor to the plain forms and any other to
the kernels of ``csrc/fr_ntt.cu`` (``groth16.ntt_kernels``): one P4 launch a
stage, the coset powers, the bit-reversed read, n^-1 and the coset inverse
powers fused into a transform's first or last stage (P5 only where a
transform has no stage, n = 1). The kernel route raises on any failure; it
never falls back. The plain forms run the butterflies limb-major
(``FR.lm_*``) on whole stages at once: ``forward_plain``,
``inverse_plain``, one stage with the kernel's fused steps
(``stage_plain``) and P5's element-wise products (``pointwise_plain``).
The JAX package had no Pallas kernel here: XLA compiles its stages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.fields.limbs import NLIMB, int_to_limbs
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


def _stage_tws(pw, hs, n):
    """Each stage's twiddles, limb-major (16, h): strided views of the
    power table pw (n/2, 16), so the stages hold no copy."""
    return tuple(pw[:: n // (2 * h)].T for h in hs)


@functools.lru_cache(maxsize=None)
def _tables_on(n: int, device: str):
    fwd, inv, ninv_m, coset, coset_inv = _tables(n)
    t = functools.partial(torch.as_tensor, device=device)
    none = np.zeros((0, NLIMB), dtype=np.int64)
    pw = t(fwd[0] if fwd else none)            # (n/2, 16) rows
    pw_inv = t(inv[-1] if inv else none)
    hs = [n >> (s + 1) for s in range(n.bit_length() - 1)]
    return dict(
        pw=pw, pw_inv=pw_inv,
        fwd=_stage_tws(pw, hs, n),
        inv=_stage_tws(pw_inv, hs[::-1], n),
        ninv=t(ninv_m),
        coset=t(coset),
        coset_inv=t(coset_inv),
        br=t(bitrev_perm(n)),
        one=t(int_to_limbs(1)),
    )


def tables(n: int, device) -> dict:
    """All NTT / coset tables for domain size n on ``device``: ``fwd`` and
    ``inv`` each stage's twiddles limb-major (16, h), in the order the
    stages run; ``pw`` and ``pw_inv`` the powers of omega and omega^-1
    below n/2 as rows (n/2, 16), which P4 reads at stride n/2h and of
    which the stages' twiddles are views; ``ninv`` n^-1, ``coset`` g^i and
    ``coset_inv`` g^-i (n, 16), all Montgomery; ``br`` the bit reversal;
    ``one`` the plain 1, the demont factor (mont_mul(x R, 1) = x)."""
    return _tables_on(n, str(torch.device(device)))


# ------------------------------------------------------------ plain forms

def _stage_view(y, tw):
    """Limb-major y (16, *lead, n) as (16, *lead, n / 2h, 2h) blocks, and
    the twiddles tw (16, h) shaped to broadcast against one half-block."""
    h = tw.shape[-1]
    n = y.shape[-1]
    blocks = y.reshape(y.shape[:-1] + (n // (2 * h), 2 * h))
    twb = tw.reshape((16,) + (1,) * (blocks.dim() - 2) + (h,))
    return blocks, twb, h


def _butterflies(y, tw, dif: bool):
    """One stage on limb-major y (16, *lead, n) with twiddles tw (16, h):
    DIF u + v, (u - v) w; DIT u + v w, u - v w."""
    blocks, twb, h = _stage_view(y, tw)
    u, v = blocks[..., :h], blocks[..., h:]
    if dif:
        s, d = FR.lm_add(u, v), FR.lm_mul(FR.lm_sub(u, v), twb)
    else:
        v = FR.lm_mul(v, twb)
        s, d = FR.lm_add(u, v), FR.lm_sub(u, v)
    return torch.cat([s, d], -1).reshape(y.shape)


def forward_plain(x: torch.Tensor, tws=None) -> torch.Tensor:
    """DIF NTT along axis -2 of int64[..., n, 16] Montgomery values."""
    if tws is None:
        tws = tables(x.shape[-2], x.device)["fwd"]
    y = x.movedim(-1, 0)
    for tw in tws:
        y = _butterflies(y, tw, True)
    return y.movedim(0, -1).contiguous()


def inverse_plain(y: torch.Tensor, tws=None, ninv=None) -> torch.Tensor:
    """DIT inverse NTT (bit-reversed in, natural out), scaled by n^-1."""
    tws, ninv = _inverse_tables(y, tws, ninv)
    x = y.movedim(-1, 0)
    for tw in tws:
        x = _butterflies(x, tw, False)
    return FR.mont_mul(x.movedim(0, -1), ninv).contiguous()


def stage_plain(y, tw, dif: bool, pre=None, bitrev: bool = False,
                post=None, post_scalar=None) -> torch.Tensor:
    """One radix-2 stage of int64[..., n, 16] values with the stage's
    twiddles tw (h, 16) as rows, DIF if ``dif`` else DIT, and P4's fused
    steps in its order: the bit-reversed gather (``bitrev``), the inputs
    times ``pre`` (n, 16), the outputs times ``post`` (n, 16) and then
    ``post_scalar`` (16,)."""
    if bitrev:
        y = y[..., torch.as_tensor(bitrev_perm(y.shape[-2]),
                                   device=y.device), :]
    if pre is not None:
        y = FR.mont_mul(y, pre)
    out = _butterflies(y.movedim(-1, 0), tw.T, dif).movedim(0, -1)
    if post is not None:
        out = FR.mont_mul(out, post)
    if post_scalar is not None:
        out = FR.mont_mul(out, post_scalar)
    return out.contiguous()


def pointwise_plain(a, t, b=None, c=None) -> torch.Tensor:
    """P5's plain form: ``a t``, or ``(a b - c) t`` with ``b`` and ``c``
    given; ``t`` one value (16,)."""
    x = a if b is None else FR.sub(FR.mont_mul(a, b), c)
    return FR.mont_mul(x, t).contiguous()


# ---------------------------------------------------- the public functions

def _plain(x) -> bool:
    """A CPU tensor takes the plain forms, any other the kernels."""
    return x.device.type == "cpu"


def _inverse_tables(y, tws, ninv):
    if tws is None or ninv is None:
        t = tables(y.shape[-2], y.device)
        tws = t["inv"] if tws is None else tws
        ninv = t["ninv"] if ninv is None else ninv
    return tws, ninv


def _powers(tws, last: bool):
    """The direction's power table (n/2, 16) rows from its stage twiddles:
    the stage of half-width n/2 holds every power (the tables' own stages
    are views of it, so this is no copy); None for n = 1."""
    if not tws:
        return None
    return tws[-1 if last else 0].T.contiguous()


def _stages(x, pw, dif: bool, pre=None, bitrev=False, post=None,
            post_scalar=None):
    """A whole transform through P4: the first stage out of place (it reads
    ``x``, in bit-reversed order if ``bitrev``, times ``pre``), the others
    in place, the last with ``post`` and ``post_scalar``. At n = 1 there is
    no stage: the products run through P5."""
    from tpu_zkpool_torch.groth16 import ntt_kernels as nk
    n = x.shape[-2]
    x = x.contiguous()
    logn = n.bit_length() - 1
    hs = [1 << s for s in range(logn)]
    if dif:
        hs.reverse()
    if not hs:                      # n = 1: each table holds one value
        y = x.clone()
        for t in (pre, post, post_scalar):
            if t is not None:
                y = nk.pointwise(y, t.reshape(NLIMB), out=y)
        return y
    y, last = x, len(hs) - 1
    for s, h in enumerate(hs):
        first = s == 0
        y = nk.stage(y, pw, h, dif, pre=pre if first else None,
                     bitrev=bitrev and first,
                     post=post if s == last else None,
                     post_scalar=post_scalar if s == last else None,
                     out=None if first else y)
    return y


def forward(x: torch.Tensor, tws=None) -> torch.Tensor:
    """DIF NTT along axis -2 of int64[..., n, 16] Montgomery values."""
    if tws is None:
        tws = tables(x.shape[-2], x.device)["fwd"]
    if _plain(x):
        return forward_plain(x, tws)
    return _stages(x, _powers(tws, False), True)


def inverse(y: torch.Tensor, tws=None, ninv=None) -> torch.Tensor:
    """DIT inverse NTT (bit-reversed in, natural out), scaled by n^-1."""
    tws, ninv = _inverse_tables(y, tws, ninv)
    if _plain(y):
        return inverse_plain(y, tws, ninv)
    return _stages(y, _powers(tws, True), False, post_scalar=ninv)


def interpolate_natural(evals, br=None, tws=None, ninv=None):
    """Natural-order domain evaluations (E[i] = P(omega^i)) -> coefficients:
    the bit-reversal gather, then ``inverse``. ``br`` is the bit reversal
    (``bitrev_perm(n)``); the kernel route reads in that order itself."""
    n = evals.shape[-2]
    tws, ninv = _inverse_tables(evals, tws, ninv)
    if _plain(evals):
        if br is None:
            br = tables(n, evals.device)["br"]
        return inverse_plain(evals[..., br, :], tws, ninv)
    if br is not None and tuple(br.shape) != (n,):
        raise ValueError(f"interpolate_natural: br must be the bit reversal "
                         f"of {n} positions, got shape {tuple(br.shape)}")
    return _stages(evals, _powers(tws, True), False, bitrev=True,
                   post_scalar=ninv)


def coset_forward(coeffs, coset=None, tws=None):
    """Evaluate a coefficient vector on the coset g * omega^i (BR order)."""
    n = coeffs.shape[-2]
    if coset is None:
        coset = tables(n, coeffs.device)["coset"]
    if tws is None:
        tws = tables(n, coeffs.device)["fwd"]
    if _plain(coeffs):
        return forward_plain(FR.mont_mul(coeffs, coset), tws)
    return _stages(coeffs, _powers(tws, False), True, pre=coset)


def coset_inverse(evals, coset_inv=None, tws=None, ninv=None):
    n = evals.shape[-2]
    if coset_inv is None:
        coset_inv = tables(n, evals.device)["coset_inv"]
    tws, ninv = _inverse_tables(evals, tws, ninv)
    if _plain(evals):
        return FR.mont_mul(inverse_plain(evals, tws, ninv), coset_inv)
    return _stages(evals, _powers(tws, True), False, post=coset_inv,
                   post_scalar=ninv)
