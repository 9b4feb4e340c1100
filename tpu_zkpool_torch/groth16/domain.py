"""Fr-domain radix-2 NTT on int64 limbs: the prover's FFT engine (the port
of ``tpu_zkpool/groth16/domain.py``).

Values are ``int64[..., n, 16]`` Montgomery Fr limbs, transformed along axis
-2. ``forward`` is decimation in frequency (natural order in, bit-reversed
out) and ``inverse`` decimation in time (bit-reversed in, natural out), with
no bit-reversal pass between them; Fr - 1 = 2^28 * odd, generator 5.

The public functions send a CPU tensor to the plain forms and any other to
the kernels of ``csrc/fr_ntt.cu`` (``groth16.ntt_kernels``): a transform is
the P4 passes of ``pass_plan`` (up to ``ntt_kernels.max_pass`` stages a
launch in shared memory, the built library's tile), reading the domain's
own tables (``tables``), the coset powers, the bit-reversed read and the
coset quotient fused into its first pass, the coset inverse powers and n^-1
into its last (P5 only where a transform has no stage, n = 1). The kernel
route raises on any failure; it never falls back. The plain forms run the
butterflies limb-major (``FR.lm_*``) on whole stages at once:
``forward_plain``, ``inverse_plain``, one stage with P4's fused steps
(``stage_plain``), a pass of them (``pass_plain``), the coset quotient
(``quotient_plain``) and P5's product (``pointwise_plain``). The JAX
package had no Pallas kernel here: XLA compiles its stages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.fields.limbs import NLIMB, int_to_limbs, unpack_limbs16
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


def pack_words(limbs: torch.Tensor) -> torch.Tensor:
    """int64[..., 16] canonical limbs -> int32[..., 8] words (limb 2i low,
    2i + 1 high: the 32-bit words P4 reads from its tables), on the
    tensor's device."""
    w = limbs[..., 0::2] | (limbs[..., 1::2] << 16)
    return w.contiguous().view(torch.int32)[..., 0::2].contiguous()


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
    coset, coset_inv = t(coset), t(coset_inv)
    return dict(
        pw=pw, pw_inv=pw_inv,
        fwd=_stage_tws(pw, hs, n),
        inv=_stage_tws(pw_inv, hs[::-1], n),
        ninv=t(ninv_m),
        ninv_demont=t(int_to_limbs(pow(n, -1, R))),
        coset=coset,
        coset_inv=coset_inv,
        br=t(bitrev_perm(n)),
        one=t(int_to_limbs(1)),
        words=dict(fwd=pack_words(pw), inv=pack_words(pw_inv),
                   coset=pack_words(coset), coset_inv=pack_words(coset_inv)),
    )


def _device_key(device) -> str:
    """``cuda`` names the current CUDA device: one key for both spellings."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def tables(n: int, device) -> dict:
    """All NTT / coset tables for domain size n on ``device``: ``fwd`` and
    ``inv`` each stage's twiddles limb-major (16, h), in the order the
    stages run; ``pw`` and ``pw_inv`` the powers of omega and omega^-1
    below n/2 as rows (n/2, 16), of which the stages' twiddles are views;
    ``ninv`` n^-1, ``coset`` g^i and ``coset_inv`` g^-i (n, 16), all
    Montgomery; ``ninv_demont`` n^-1 plain (mont_mul(x, n^-1) = n^-1
    mont_mul(x, 1): the inverse's scale with the demont step folded in);
    ``br`` the bit reversal; ``one`` the plain 1, the demont factor
    (mont_mul(x R, 1) = x); ``words`` the power tables (``fwd``, ``inv``)
    and the coset tables as P4 reads them (``pack_words``, packed on the
    device from the rows above)."""
    return _tables_on(n, _device_key(device))


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


def pass_half_widths(n: int, h_first: int, count: int, dif: bool) -> list:
    """The half-widths of a pass's stages in order (DIF halving from
    ``h_first``, DIT doubling); ``ValueError`` unless all lie in [1, n/2]."""
    hs = [h_first >> s if dif else h_first << s for s in range(count)]
    if (count < 1 or h_first < 1 or h_first & (h_first - 1)
            or min(hs) < 1 or max(hs) > n // 2):
        raise ValueError(f"a pass of {count} stages from h = {h_first} does "
                         f"not fit n = {n}")
    return hs


def pass_plain(y, pw, h_first: int, count: int, dif: bool, pre=None,
               bitrev: bool = False, post=None, post_scalar=None,
               quotient=None) -> torch.Tensor:
    """P4's plain form: ``count`` stages (``stage_plain``) of int64[..., n,
    16] values from half-width ``h_first``, DIF halving or DIT doubling,
    with the pass's fused steps in the kernel's order: the bit-reversed
    gather (``bitrev``; ``quotient``'s b and c gathered alike), the
    quotient (``quotient = (b, c, t)``: the values become (y b - c) t),
    ``pre`` on the first stage's inputs, ``post`` and then ``post_scalar``
    (16,) limbs on the last stage's outputs. ``pw`` (n/2, 8), ``pre`` and
    ``post`` (n, 8) are packed words (``pack_words``)."""
    n = y.shape[-2]
    hs = pass_half_widths(n, h_first, count, dif)
    if bitrev:
        perm = torch.as_tensor(bitrev_perm(n), device=y.device)
        y = y[..., perm, :]
        if quotient is not None:
            b, c, t = quotient
            quotient = (b[..., perm, :], c[..., perm, :], t)
    if quotient is not None:
        y = quotient_plain(y, *quotient)
    pw = unpack_limbs16(pw)
    pre, post = (None if x is None else unpack_limbs16(x) for x in (pre, post))
    for s, h in enumerate(hs):
        last = s == count - 1
        y = stage_plain(y, pw[:: n // (2 * h)], dif,
                        pre=pre if s == 0 else None,
                        post=post if last else None,
                        post_scalar=post_scalar if last else None)
    return y


def quotient_plain(y, b, c, t) -> torch.Tensor:
    """The coset quotient (y b - c) t, ``t`` one value (16,): the plain
    form of P4's quotient prologue."""
    return FR.mont_mul(FR.sub(FR.mont_mul(y, b), c), t).contiguous()


def pointwise_plain(a, t) -> torch.Tensor:
    """P5's plain form: ``a t``, ``t`` one value (16,)."""
    return FR.mont_mul(a, t).contiguous()


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


def _words(x, key, given):
    """The packed words P4 reads for table ``key`` (``fwd``, ``inv``: the
    direction's power table; ``coset``, ``coset_inv``), packed once in
    ``tables``. ``given``, a caller's table, must be None or the tables'
    own entry: ``ValueError`` for any other."""
    t = tables(x.shape[-2], x.device)
    if given is not None and given is not t[key]:
        raise ValueError(f"the kernel route reads the domain's own tables "
                         f"(domain.tables); {key} is another")
    return t["words"][key]


def pass_plan(log_n: int, max_pass: int) -> list:
    """The stages of each P4 launch of a transform of 2^log_n values:
    ceil(log_n / max_pass) passes split as evenly as possible, the larger
    first (a tile of 2^11: 2^21 11 + 10, 2^14 7 + 7). ``max_pass`` is the
    kernel's tile, ``ntt_kernels.max_pass``."""
    p = -(-log_n // max_pass)
    if p == 0:
        return []
    return [log_n // p + (i < log_n % p) for i in range(p)]


def _passes(x, pw, dif: bool, pre=None, bitrev=False, post=None,
            post_scalar=None, quotient=None):
    """A whole transform through P4's passes (``pass_plan``): the first out
    of place (it reads ``x``, in bit-reversed order if ``bitrev``, as the
    quotient with ``quotient``, times ``pre``), the others in place, the
    last with ``post`` and ``post_scalar``. DIF passes run from the top
    index bits down, DIT from the bottom up. At n = 1 there is no stage:
    the products run through P5 (``coset_inverse`` takes no quotient
    there)."""
    from tpu_zkpool_torch.groth16 import ntt_kernels as nk
    n = x.shape[-2]
    x = x.contiguous()
    logn = n.bit_length() - 1
    if logn == 0:                   # each table holds one value
        y = x.clone()
        for t in (pre, post):
            if t is not None:
                y = nk.pointwise(y, unpack_limbs16(t).reshape(NLIMB), out=y)
        if post_scalar is not None:
            y = nk.pointwise(y, post_scalar, out=y)
        return y
    plan = pass_plan(logn, nk.max_pass(x.device))
    y, bit = x, logn if dif else 0
    for p, count in enumerate(plan):
        first, last = p == 0, p == len(plan) - 1
        y = nk.fr_pass(y, pw, 1 << (bit - 1 if dif else bit), count, dif,
                       pre=pre if first else None, bitrev=bitrev and first,
                       post=post if last else None,
                       post_scalar=post_scalar if last else None,
                       quotient=quotient if first else None,
                       out=None if first else y)
        bit += -count if dif else count
    return y


def forward(x: torch.Tensor, tws=None) -> torch.Tensor:
    """DIF NTT along axis -2 of int64[..., n, 16] Montgomery values."""
    if _plain(x):
        return forward_plain(x, tws)
    return _passes(x, _words(x, "fwd", tws), True)


def inverse(y: torch.Tensor, tws=None, ninv=None) -> torch.Tensor:
    """DIT inverse NTT (bit-reversed in, natural out), scaled by n^-1."""
    if _plain(y):
        return inverse_plain(y, tws, ninv)
    ninv = _inverse_tables(y, tws, ninv)[1]
    return _passes(y, _words(y, "inv", tws), False, post_scalar=ninv)


def interpolate_natural(evals, br=None, tws=None, ninv=None):
    """Natural-order domain evaluations (E[i] = P(omega^i)) -> coefficients:
    the bit-reversal gather, then ``inverse``. ``br`` is the bit reversal
    (``bitrev_perm(n)``); the kernel route reads in that order itself."""
    n = evals.shape[-2]
    if _plain(evals):
        if br is None:
            br = tables(n, evals.device)["br"]
        return inverse_plain(evals[..., br, :], tws, ninv)
    if br is not None and tuple(br.shape) != (n,):
        raise ValueError(f"interpolate_natural: br must be the bit reversal "
                         f"of {n} positions, got shape {tuple(br.shape)}")
    ninv = _inverse_tables(evals, tws, ninv)[1]
    return _passes(evals, _words(evals, "inv", tws), False, bitrev=True,
                   post_scalar=ninv)


def coset_forward(coeffs, coset=None, tws=None):
    """Evaluate a coefficient vector on the coset g * omega^i (BR order)."""
    if _plain(coeffs):
        if coset is None:
            coset = tables(coeffs.shape[-2], coeffs.device)["coset"]
        return forward_plain(FR.mont_mul(coeffs, coset), tws)
    return _passes(coeffs, _words(coeffs, "fwd", tws), True,
                   pre=_words(coeffs, "coset", coset))


def coset_inverse(evals, coset_inv=None, tws=None, ninv=None, *,
                  quotient=None):
    """Coefficients from values on the coset: ``inverse`` and the coset
    inverse powers g^-i. With ``quotient = (b, c, t)`` the values are (evals
    b - c) t, the coset quotient, which the kernel route reads in its first
    pass (no buffer of them is written); n must be 2 or more."""
    if quotient is not None and evals.shape[-2] < 2:
        raise ValueError("coset_inverse: a quotient needs n >= 2 (its "
                         "prologue rides a transform's first pass)")
    if _plain(evals):
        if coset_inv is None:
            coset_inv = tables(evals.shape[-2], evals.device)["coset_inv"]
        if quotient is not None:
            evals = quotient_plain(evals, *quotient)
        return FR.mont_mul(inverse_plain(evals, tws, ninv), coset_inv)
    ninv = _inverse_tables(evals, tws, ninv)[1]
    return _passes(evals, _words(evals, "inv", tws), False,
                   post=_words(evals, "coset_inv", coset_inv),
                   post_scalar=ninv, quotient=quotient)
