"""Batched BN254 optimal-ate pairing, on the GPU.

The port of ``tpu_zkpool/curve/pairing_jax.py``. The batched Groth16 verify
runs the multi-leg Miller loop over precomputed line coefficients
(``miller_loop_lines``), the cyclotomic final exponentiation
(``final_exponentiation``) and the check of their product against a target
(``pairing_lines_equal``). The JAX package compiles the
two into one XLA program (``_ppl_jit``), with no ``pl.pallas_call``; as
eager torch ops on the card they would be ~1.5-2 million small kernel
launches a batch, so here each is one hand-written CUDA kernel, P1
``k_miller_lines`` and P2 ``k_final_exp`` (``csrc/pairing.cu``, wrappers in
``pairing_kernels``). On a CUDA tensor both dispatch to the kernels, on a
CPU tensor to the plain versions below, built on ``tower``.

The naive pairing (``miller_loop``, the G2 point walked in the loop with
affine lines and an Fp2 inverse a step, ``f12_pow_const`` and
``pairing_product_is_one``) is torch ops over ``tower`` on the points'
device; only its final exponentiation is P2 on a CUDA tensor. The verify
does not use it. The TPU's AOT export cache has no counterpart.

Fp12 values are int64[B, 12, 16] Montgomery limbs (``tower``'s layout).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch.curve import tower as tw
from tpu_zkpool_torch.curve.lines import ATE_BITS
from tpu_zkpool_torch.fields.bn254 import BN_X
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.refimpl import pairing_ref as pr


@functools.lru_cache(maxsize=None)
def _gamma(power: int, device) -> torch.Tensor:
    """xi^(i (p^power - 1) / 6), i = 0 .. 5, as Fp2 limbs [6, 2, 16]."""
    return torch.stack([tw.f2_const(g, device) for g in pr._gamma(power)])


def f12_frobenius(a, power: int):
    """a^(p^power): conj^power per Fp2 coefficient, times gamma_power."""
    c = tw.f12_coeffs(a)
    if power % 2:
        c = tw.f2_conj(c)
    return tw.f12_join(tw.f2_mul(c, _gamma(power, a.device)))


def f12_inv(a):
    """Batched Fp12 inverse via the even-subalgebra trick: a * conj(a) is
    even in w (an Fp6 element over v = w^2, v^3 = xi), which inverts in
    closed form; then a^-1 = conj(a) * (a * conj(a))^-1."""
    c = tw.f12_conj(a)
    n = tw.f12_coeffs(tw.f12_mul(a, c))
    g0, g1, g2 = n[..., 0, :, :], n[..., 2, :, :], n[..., 4, :, :]
    # g0^2, g2^2, g1^2, g1 g2, g0 g1, g0 g2 in one product
    pr6 = tw.f2_mul(torch.stack([g0, g2, g1, g1, g0, g0], -3),
                    torch.stack([g0, g2, g1, g2, g1, g2], -3))
    xi = tw.f2_mul_by_xi(pr6[..., [3, 1], :, :])        # xi g1 g2, xi g2^2
    cs = tw.f2_sub(torch.stack([pr6[..., 0, :, :], xi[..., 1, :, :],
                                pr6[..., 2, :, :]], -3),
                   torch.stack([xi[..., 0, :, :], pr6[..., 4, :, :],
                                pr6[..., 5, :, :]], -3))  # c0, c1, c2
    t = tw.f2_mul(torch.stack([g0, g2, g1], -3), cs)     # g0 c0, g2 c1, g1 c2
    den = tw.f2_add(t[..., 0, :, :], tw.f2_mul_by_xi(
        tw.f2_add(t[..., 1, :, :], t[..., 2, :, :])))
    gi = tw.f2_mul(cs, tw.f2_inv(den).unsqueeze(-3))
    z = torch.zeros_like(gi[..., 0, :, :])
    ginv = torch.stack([gi[..., 0, :, :], z, gi[..., 1, :, :], z,
                        gi[..., 2, :, :], z], -3)
    return tw.f12_mul(c, tw.f12_join(ginv))


def f12_cyclotomic_sqr(a):
    """Granger-Scott squaring (cyclotomic subgroup only): the pairs (a0,
    a3), (a1, a4), (a2, a5) are Fp4 elements; their nine Fp2 squares in
    one call."""
    c = tw.f12_coeffs(a)
    x, y = c[..., 0:3, :, :], c[..., 3:6, :, :]
    sq = tw.f2_sqr(torch.cat([x, y, tw.f2_add(x, y)], -3))
    x2, y2, s2 = sq[..., 0:3, :, :], sq[..., 3:6, :, :], sq[..., 6:9, :, :]
    te = tw.f2_add(x2, tw.f2_mul_by_xi(y2))          # t0, t2, t4
    to = tw.f2_sub(tw.f2_sub(s2, x2), y2)            # t1, t3, t5
    # z_i = 3 T_i - 2 a_i (i even), 3 T_i + 2 a_i (i odd), with
    # T = (t0, xi t5, t2, t1, t4, t3)
    T = torch.stack([te[..., 0, :, :], tw.f2_mul_by_xi(to[..., 2, :, :]),
                     te[..., 1, :, :], to[..., 0, :, :], te[..., 2, :, :],
                     to[..., 1, :, :]], -3)
    T3 = tw.f2_add(tw.f2_add(T, T), T)
    C2 = tw.f2_add(c, c)
    out = torch.empty_like(c)
    out[..., 0::2, :, :] = tw.f2_sub(T3[..., 0::2, :, :], C2[..., 0::2, :, :])
    out[..., 1::2, :, :] = tw.f2_add(T3[..., 1::2, :, :], C2[..., 1::2, :, :])
    return tw.f12_join(out)


def f12_pow_x_cyclo(a):
    """a^BN_X with cyclotomic squarings (BN_X has MSB 1: the accumulator
    starts at ``a`` and the remaining bits are scanned)."""
    acc = a
    for ch in bin(BN_X)[3:]:
        acc = f12_cyclotomic_sqr(acc)
        if ch == "1":
            acc = tw.f12_mul(acc, a)
    return acc


# The hard part of the final exponentiation as a register program over 15
# Fp12 registers (the JAX package's _fe_program, copied as data): static
# (kind, a, b, dst) steps, everything after inv(f). r0 = f, r1 = inv(f) on
# entry; the result lands in r14. P2 runs the same steps as straight-line
# code.
_MUL, _SQR, _FROB, _CONJ, _MOV = range(5)
FE_NREG = 15
FE_OUT = 14


def _fe_program():
    ops = []

    def emit(kind, a, b, dst):
        ops.append((kind, a, b, dst))

    def pow_x(src, dst):
        emit(_MOV, src, 0, dst)
        for ch in bin(BN_X)[3:]:
            emit(_SQR, dst, 0, dst)
            if ch == "1":
                emit(_MUL, dst, src, dst)

    # easy part: m = frob2(f^(p^6-1)) * f^(p^6-1)
    emit(_CONJ, 0, 0, 2)
    emit(_MUL, 2, 1, 2)          # r2 = conj(f) * inv(f) = f^(p^6-1)
    emit(_FROB, 2, 2, 1)         # r1 = r2^(p^2)
    emit(_MUL, 1, 2, 2)          # r2 = m
    # x-power ladder
    pow_x(2, 3)                  # r3 = fx
    pow_x(3, 4)                  # r4 = fx2
    pow_x(4, 5)                  # r5 = fx3
    # y terms
    emit(_FROB, 2, 1, 6)         # r6 = m^p
    emit(_FROB, 2, 2, 7)         # r7 = m^(p^2)
    emit(_MUL, 6, 7, 6)
    emit(_FROB, 2, 3, 7)         # r7 = m^(p^3)
    emit(_MUL, 6, 7, 6)          # r6 = y0
    emit(_CONJ, 2, 0, 7)         # r7 = y1
    emit(_FROB, 4, 2, 8)         # r8 = y2
    emit(_FROB, 3, 1, 9)
    emit(_CONJ, 9, 0, 9)         # r9 = y3
    emit(_FROB, 4, 1, 10)
    emit(_MUL, 3, 10, 10)
    emit(_CONJ, 10, 0, 10)       # r10 = y4
    emit(_CONJ, 4, 0, 11)        # r11 = y5
    emit(_FROB, 5, 1, 12)
    emit(_MUL, 5, 12, 12)
    emit(_CONJ, 12, 0, 12)       # r12 = y6
    # Scott et al. combine
    emit(_SQR, 12, 0, 12)        # T0 = y6^2
    emit(_MUL, 12, 10, 12)       # * y4
    emit(_MUL, 12, 11, 12)       # * y5
    emit(_MUL, 9, 11, 13)        # T1 = y3 * y5
    emit(_MUL, 13, 12, 13)       # * T0
    emit(_MUL, 12, 8, 12)        # T0 *= y2
    emit(_SQR, 13, 0, 13)
    emit(_MUL, 13, 12, 13)
    emit(_SQR, 13, 0, 13)
    emit(_MUL, 13, 7, 14)        # T0' = T1 * y1
    emit(_MUL, 13, 6, 13)        # T1 *= y0
    emit(_SQR, 14, 0, 14)
    emit(_MUL, 14, 13, 14)       # result -> r14
    return np.asarray(ops, dtype=np.int32)


FE_PROGRAM = _fe_program()


def final_exponentiation_plain(f):
    """P2's plain version: f^((p^12-1)/r) for f [B, 12, 16], the easy part
    then ``FE_PROGRAM`` (the same steps as the JAX scan)."""
    reg = [f, f12_inv(f)] + [None] * (FE_NREG - 2)
    for kind, a, b, dst in FE_PROGRAM.tolist():
        A = reg[a]
        if kind == _MUL:
            reg[dst] = tw.f12_mul(A, reg[b])
        elif kind == _SQR:
            reg[dst] = f12_cyclotomic_sqr(A)
        elif kind == _FROB:
            reg[dst] = f12_frobenius(A, b)
        elif kind == _CONJ:
            reg[dst] = tw.f12_conj(A)
        else:
            reg[dst] = A
    return reg[FE_OUT]


def _line_eval(f, px, py, an0, an1, b0, b1):
    """f *= the line with precomputed coefficients: l0 = py, l1 =
    alpha_neg * px, l3 = beta (``lines``): two Fp products (one call) and
    one sparse Fp12 product."""
    l1 = FP.mont_mul(torch.stack(torch.broadcast_tensors(an0, an1), -2),
                     px.unsqueeze(-2))
    l0 = torch.stack([py, torch.zeros_like(py)], -2)
    return tw.f12_mul_sparse_line(f, l0, l1, torch.stack(
        torch.broadcast_tensors(b0, b1), -2))


def miller_loop_lines_plain(g1s, legs):
    """P1's plain version: the multi-leg Miller loop over precomputed lines
    (g1s: list of (px, py) int64[B, 16]; legs: matching ``LineArrays``).
    One shared Fp12 squaring chain serves every leg; the add lines run
    where an ATE bit is set (JAX computes both and selects)."""
    B = g1s[0][0].shape[0]
    f = tw.f12_one((B,), g1s[0][0].device)
    for s, bit in enumerate(ATE_BITS):
        f = tw.f12_sqr(f)
        for (px, py), lg in zip(g1s, legs):
            f = _line_eval(f, px, py, lg.dbl_an0[s], lg.dbl_an1[s],
                           lg.dbl_b0[s], lg.dbl_b1[s])
        if bit:
            for (px, py), lg in zip(g1s, legs):
                f = _line_eval(f, px, py, lg.add_an0[s], lg.add_an1[s],
                               lg.add_b0[s], lg.add_b1[s])
    for i in range(2):
        for (px, py), lg in zip(g1s, legs):
            f = _line_eval(f, px, py, lg.end_an0[i], lg.end_an1[i],
                           lg.end_b0[i], lg.end_b1[i])
    return f


def miller_loop_lines(g1s, legs):
    """Multi-pairing Miller loop over precomputed line coefficients -> f
    int64[B, 12, 16]: kernel P1 on a CUDA tensor, the plain version on a
    CPU tensor."""
    from tpu_zkpool_torch.curve import pairing_kernels
    return pairing_kernels.miller_lines(g1s, legs)


def final_exponentiation(f):
    """f^((p^12-1)/r) for f [B, 12, 16]: kernel P2 on a CUDA tensor, the
    plain version on a CPU tensor."""
    from tpu_zkpool_torch.curve import pairing_kernels
    return pairing_kernels.final_exp(f)


# ----------------------------------------------------------- host helpers

def g1_to_limbs(pts, device):
    """Affine G1 int points -> (xs, ys) Montgomery limbs int64[n, 16]."""
    xs = FP.to_mont(np.asarray([p[0] for p in pts], dtype=object))
    ys = FP.to_mont(np.asarray([p[1] for p in pts], dtype=object))
    return (torch.as_tensor(xs, device=device),
            torch.as_tensor(ys, device=device))


def f12_to_limbs(f, device) -> torch.Tensor:
    """Host Fp12 (6 Fp2 int pairs, ``pairing_ref`` layout) -> Montgomery
    limbs int64[12, 16]."""
    return tw.f12_from_ints([f], device)[0]


def pairing_lines_equal(g1_points, legs, target=None) -> torch.Tensor:
    """Batched check prod_i e(P_i, Q_i) == target with precomputed Q lines
    -> bool[B] on the points' device. ``target``: host Fp12 (``pairing_ref``
    layout), device limbs [12, 16], or None for 1 (e.g. the per-VK constant
    e(alpha, beta) that replaces a Miller-loop leg in Groth16)."""
    dev = g1_points[0][0].device
    if target is None:
        tl = tw.f12_one((), dev)
    elif isinstance(target, torch.Tensor):
        tl = target
    else:
        tl = f12_to_limbs(target, dev)
    fe = final_exponentiation(miller_loop_lines(list(g1_points), list(legs)))
    return (fe == tl).flatten(-2).all(-1)


# ------------------------------------------------------- the naive pairing

def _line(t, q, px, py, is_double: bool):
    """Line through t, q (affine Fp2 points, each coordinate [..., 2, 16])
    evaluated at the G1 point (px, py) [..., 16]. Returns (new_t, (l0, l1,
    l3)), the coefficients of w^0, w^1, w^3. Batched; the caller guarantees
    the non-degenerate case (subgroup points in the Miller loop)."""
    tx, ty = t
    qx, qy = q
    if is_double:
        num = tw.f2_scalar_small(tw.f2_sqr(tx), 3)
        den = tw.f2_add(ty, ty)
    else:
        num = tw.f2_sub(qy, ty)
        den = tw.f2_sub(qx, tx)
    lam = tw.f2_mul(num, tw.f2_inv(den))
    x3 = tw.f2_sub(tw.f2_sub(tw.f2_sqr(lam), tx), qx)
    y3 = tw.f2_sub(tw.f2_mul(lam, tw.f2_sub(tx, x3)), ty)
    l0 = torch.stack([py, torch.zeros_like(py)], -2)
    l1 = tw.f2_neg(FP.mont_mul(lam, px.unsqueeze(-2)))
    l3 = tw.f2_sub(tw.f2_mul(lam, tx), ty)
    return (x3, y3), (l0, l1, l3)


def _g2_frobenius(q):
    """pi(x, y) = (conj(x) xi^((p-1)/3), conj(y) xi^((p-1)/2))."""
    x, y = q
    dev = x.device
    return (tw.f2_mul(tw.f2_conj(x), tw.f2_const(pr._XI_P_13, dev)),
            tw.f2_mul(tw.f2_conj(y), tw.f2_const(pr._XI_P_12, dev)))


def miller_loop(px, py, qx, qy):
    """f_{6x+2,Q}(P) with the Frobenius end-steps, batched over the leading
    shape: px, py int64[..., 16] G1 affine (Montgomery), qx, qy Fp2
    [..., 2, 16] of the same batch shape -> Fp12 [..., 12, 16]. The add
    step runs where an ATE bit is set (JAX computes it at every bit and
    selects)."""
    f = tw.f12_one(px.shape[:-1], px.device)
    q = (qx, qy)
    t = q
    for bit in ATE_BITS:
        f = tw.f12_sqr(f)
        t, line = _line(t, t, px, py, True)
        f = tw.f12_mul_sparse_line(f, *line)
        if bit:
            t, line = _line(t, q, px, py, False)
            f = tw.f12_mul_sparse_line(f, *line)
    q1 = _g2_frobenius(q)
    q2 = _g2_frobenius(q1)
    q2 = (q2[0], tw.f2_neg(q2[1]))
    t, line = _line(t, q1, px, py, False)
    f = tw.f12_mul_sparse_line(f, *line)
    t, line = _line(t, q2, px, py, False)
    return tw.f12_mul_sparse_line(f, *line)


def f12_pow_const(a, e: int):
    """a^e for a fixed Python-int exponent, MSB first from one."""
    acc = tw.f12_one(a.shape[:-2], a.device)
    for ch in bin(e)[2:]:
        acc = tw.f12_sqr(acc)
        if ch == "1":
            acc = tw.f12_mul(acc, a)
    return acc


def g2_to_limbs(pts, device):
    """Affine G2 int points (pairs of Fp2 pairs) -> (qx, qy) Montgomery
    limbs, each int64[n, 2, 16]."""
    def coord(i):
        arr = np.asarray([[p[i][0], p[i][1]] for p in pts], dtype=object)
        return torch.as_tensor(FP.to_mont(arr), device=device)
    return coord(0), coord(1)


def pairing_product_is_one(g1_points, g2_points) -> torch.Tensor:
    """Batched check prod_i e(P_i, Q_i) == 1 -> bool[...] on the points'
    device. g1_points: list of (px, py) int64[..., 16]; g2_points: the
    matching list of (qx, qy) Fp2 [..., 2, 16]. The pairs' Miller loops run
    as one batch of torch ops (stacked on a leading axis: the loop is
    launch-bound, so k pairs cost about one); the final exponentiation is
    P2 on a CUDA tensor, its plain version on a CPU tensor."""
    def stack(ts):
        return torch.stack(torch.broadcast_tensors(*ts))
    ml = miller_loop(stack([p[0] for p in g1_points]),
                     stack([p[1] for p in g1_points]),
                     stack([q[0] for q in g2_points]),
                     stack([q[1] for q in g2_points]))
    f = ml[0]
    for i in range(1, ml.shape[0]):
        f = tw.f12_mul(f, ml[i])
    shape = f.shape[:-2]
    fe = final_exponentiation(f.reshape(-1, 12, 16).contiguous())
    return tw.f12_eq_one(fe).reshape(shape)
