"""Precomputed Miller-loop line coefficients for fixed or known G2 points.

The port of ``tpu_zkpool/curve/lines.py``. A Groth16 verification pairs
each proof leg against a G2 point that is either fixed by the verifying key
(gamma, delta, the Pedersen commitment key) or known on the host at verify
time (the proof's B). The schedule 6x+2 is walked once on the host in exact
bigint arithmetic, and each line's two Fp2 coefficients that do not depend
on the G1 argument are recorded:

    l(P) = py + (-lam * px) * w + (lam * t_x - t_y) * w^3

i.e. ``alpha_neg = -lam`` and ``beta = lam * t_x - t_y``. The device then
evaluates each line with two Fp products and one sparse Fp12 product (the
pairing kernel P1, ``csrc/pairing.cu``), with no Fp2 inversion and no G2
arithmetic. One double line per ATE bit, one add line per set bit
(zero-filled otherwise), then the two Frobenius end lines.

The host walk is copied as it is, with one repair: ``_batch_f2_inv`` skips
a zero norm (see there), where the reference lets one zero denominator
corrupt every proof's lines.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.fields.bn254 import BN_X, FP_MOD as P
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.refimpl import pairing_ref as pr

ATE_BITS = [int(b) for b in bin(6 * BN_X + 2)[3:]]  # MSB dropped
N_STEPS = len(ATE_BITS)


class LineArrays(NamedTuple):
    """Device line coefficients for one pairing leg.

    Every tensor is Montgomery limbs int64[S, (batch,) 16] where S is the
    step axis of ``pairing.miller_loop_lines``: ``dbl_*`` / ``add_*`` have
    S = len(ATE_BITS), ``end_*`` has S = 2. A fixed leg has no batch axis
    (the kernel reads it at batch stride 0), a per-proof leg has one.
    ``*_an0/an1`` are the Fp2 components of ``-lam``; ``*_b0/b1`` of
    ``lam*t_x - t_y``.
    """
    dbl_an0: torch.Tensor
    dbl_an1: torch.Tensor
    dbl_b0: torch.Tensor
    dbl_b1: torch.Tensor
    add_an0: torch.Tensor
    add_an1: torch.Tensor
    add_b0: torch.Tensor
    add_b1: torch.Tensor
    end_an0: torch.Tensor
    end_an1: torch.Tensor
    end_b0: torch.Tensor
    end_b1: torch.Tensor


def _coeffs_dbl(t):
    """(alpha_neg, beta) of the tangent line at t; new t = 2t."""
    tx, ty = t
    lam = pr.f2_mul(pr.f2_scalar(pr.f2_sqr(tx), 3),
                    pr.f2_inv(pr.f2_scalar(ty, 2)))
    x3 = pr.f2_sub(pr.f2_sub(pr.f2_sqr(lam), tx), tx)
    y3 = pr.f2_sub(pr.f2_mul(lam, pr.f2_sub(tx, x3)), ty)
    beta = pr.f2_sub(pr.f2_mul(lam, tx), ty)
    return (x3, y3), pr.f2_neg(lam), beta


def _coeffs_add(t, q):
    """(alpha_neg, beta) of the chord through t and q; new t = t + q."""
    tx, ty = t
    qx, qy = q
    lam = pr.f2_mul(pr.f2_sub(qy, ty), pr.f2_inv(pr.f2_sub(qx, tx)))
    x3 = pr.f2_sub(pr.f2_sub(pr.f2_sqr(lam), tx), qx)
    y3 = pr.f2_sub(pr.f2_mul(lam, pr.f2_sub(tx, x3)), ty)
    beta = pr.f2_sub(pr.f2_mul(lam, tx), ty)
    return (x3, y3), pr.f2_neg(lam), beta


_F2Z = (0, 0)


def g2_line_schedule(q):
    """Walk the 6x+2 Miller schedule for G2 point ``q`` on the host.

    Returns (dbl, add, end): lists of (alpha_neg, beta) Fp2 int pairs with
    len(dbl) = len(add) = N_STEPS and len(end) = 2; ``add[i]`` is zeros
    where ATE bit i is 0 (the device skips those lines).
    """
    t = q
    dbl, add = [], []
    for b in ATE_BITS:
        t, an, beta = _coeffs_dbl(t)
        dbl.append((an, beta))
        if b:
            t, an, beta = _coeffs_add(t, q)
            add.append((an, beta))
        else:
            add.append((_F2Z, _F2Z))
    q1 = pr.g2_frobenius(q)
    q2 = pr.g2_neg(pr.g2_frobenius(q1))
    end = []
    t, an, beta = _coeffs_add(t, q1)
    end.append((an, beta))
    t, an, beta = _coeffs_add(t, q2)
    end.append((an, beta))
    return dbl, add, end


def _pack(schedules, device) -> LineArrays:
    """[(dbl, add, end)] per batch element -> LineArrays on ``device``.

    One schedule gives unbatched tensors (S, 16); n > 1 stack to (S, n, 16)
    so the step axis stays leading.
    """
    cols = []
    for part in range(3):                      # dbl, add, end
        for coeff in range(2):                 # alpha_neg, beta
            for comp in range(2):              # Fp2 c0, c1
                col = [[entry[coeff][comp] for entry in sched[part]]
                       for sched in schedules]
                arr = FP.to_mont(np.asarray([v for row in col for v in row],
                                            dtype=object))
                S = len(col[0])
                if len(schedules) == 1:
                    arr = arr.reshape(S, 16)
                else:
                    arr = arr.reshape(len(schedules), S, 16).transpose(1, 0,
                                                                       2)
                cols.append(torch.as_tensor(np.ascontiguousarray(arr),
                                            device=device))
    # cols order: dbl(an0,an1,b0,b1), add(...), end(...)
    return LineArrays(*cols)


def precompute_g2_lines(q, device=None) -> LineArrays:
    """Line coefficients for one fixed G2 point (per VK; cache the result)."""
    dev = resolve_device(device)
    return _pack([g2_line_schedule(q)], dev)


def _batch_f2_inv(ds):
    """Invert a list of Fp2 values with ONE Fp inversion in all: per-value
    norm n = a^2 + b^2 (u^2 = -1), Montgomery-trick batch inversion of the
    norms, then inv = conj / norm.

    Zero-norm guard (a repair of the reference, which has none): a value
    whose norm is 0 (only 0 itself, since -1 is not a square mod p) takes 1
    in the running product and gets the inverse (0, 0); the others stay
    exact. Without the guard one zero denominator zeroes the product and
    every value's inverse with it. Returns (inverses, indices of the zero
    norms)."""
    norms = [(a * a + b * b) % P for a, b in ds]
    zero = [i for i, n in enumerate(norms) if n == 0]
    for i in zero:
        norms[i] = 1
    pref = [1]
    for n in norms:
        pref.append(pref[-1] * n % P)
    inv_all = pow(pref[-1], P - 2, P)
    out = [None] * len(ds)
    for i in range(len(ds) - 1, -1, -1):
        ninv = inv_all * pref[i] % P
        inv_all = inv_all * norms[i] % P
        a, b = ds[i]
        out[i] = (a * ninv % P, (-b * ninv) % P)
    return out, zero


def g2_line_schedules_batch(qs, degenerate=None):
    """``g2_line_schedule`` for many G2 points at once, with the per-step
    Fp2 inversions batched across the points (one Fp exponentiation per
    schedule step instead of one per point per step). If ``degenerate`` is
    a set, the indices of the points that met a zero denominator are added
    to it: their lines are not the point's, every other point's are."""
    n = len(qs)
    ts = list(qs)
    dbl = [[] for _ in range(n)]
    add = [[] for _ in range(n)]
    bad = set()

    def steps(is_dbl, out_lists):
        if is_dbl:
            dens = [pr.f2_scalar(ty, 2) for (_, ty) in ts]
            nums = [pr.f2_scalar(pr.f2_sqr(tx), 3) for (tx, _) in ts]
            qs_step = ts
        else:
            dens = [pr.f2_sub(qx, tx) for (tx, _), (qx, _) in zip(ts, qs)]
            nums = [pr.f2_sub(qy, ty) for (_, ty), (_, qy) in zip(ts, qs)]
            qs_step = qs
        invs, zero = _batch_f2_inv(dens)
        bad.update(zero)
        for i in range(n):
            tx, ty = ts[i]
            qx, _ = qs_step[i]
            lam = pr.f2_mul(nums[i], invs[i])
            x3 = pr.f2_sub(pr.f2_sub(pr.f2_sqr(lam), tx), qx)
            y3 = pr.f2_sub(pr.f2_mul(lam, pr.f2_sub(tx, x3)), ty)
            beta = pr.f2_sub(pr.f2_mul(lam, tx), ty)
            ts[i] = (x3, y3)
            out_lists[i].append((pr.f2_neg(lam), beta))

    for b in ATE_BITS:
        steps(True, dbl)
        if b:
            steps(False, add)
        else:
            for lst in add:
                lst.append((_F2Z, _F2Z))
    end = [[] for _ in range(n)]
    q1s = [pr.g2_frobenius(q) for q in qs]
    q2s = [pr.g2_neg(pr.g2_frobenius(q1)) for q1 in q1s]
    for qstep in (q1s, q2s):
        dens = [pr.f2_sub(qx, tx) for (tx, _), (qx, _) in zip(ts, qstep)]
        invs, zero = _batch_f2_inv(dens)
        bad.update(zero)
        for i in range(n):
            tx, ty = ts[i]
            qx, qy = qstep[i]
            lam = pr.f2_mul(pr.f2_sub(qy, ty), invs[i])
            x3 = pr.f2_sub(pr.f2_sub(pr.f2_sqr(lam), tx), qx)
            y3 = pr.f2_sub(pr.f2_mul(lam, pr.f2_sub(tx, x3)), ty)
            beta = pr.f2_sub(pr.f2_mul(lam, tx), ty)
            ts[i] = (x3, y3)
            end[i].append((pr.f2_neg(lam), beta))
    if degenerate is not None:
        degenerate.update(bad)
    return [(dbl[i], add[i], end[i]) for i in range(n)]


def precompute_g2_lines_batch(qs, device=None) -> LineArrays:
    """Batched per-proof lines: qs = [Fp2 affine pairs] -> (S, n, 16)
    tensors on ``device``. Raises ValueError, naming the indices, if a
    point meets a zero denominator (its lines would not be its own)."""
    dev = resolve_device(device)
    bad = set()
    sched = g2_line_schedules_batch(qs, bad)
    if bad:
        raise ValueError(f"precompute_g2_lines_batch: points {sorted(bad)} "
                         f"meet a zero denominator")
    return _pack(sched, dev)
