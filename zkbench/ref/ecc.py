"""BN254 G1 and G2 in affine coordinates over Python ints: the plain
arithmetic the benchmark's reference multiplies the generators with.
Points are (x, y), G2 coordinates elements of Fp2 = Fp[u]/(u^2 + 1) as
pairs; None is the identity."""

from __future__ import annotations

from zkbench.ref.bn254 import FP_MOD as P, G1_GX, G1_GY, G2_GX, G2_GY

G1_GEN = (G1_GX, G1_GY)
G2_GEN = (G2_GX, G2_GY)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_mul(k: int, p):
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_add(p, p)
        k >>= 1
    return acc


def _f2_mul(a, b):
    t0, t1 = a[0] * b[0], a[1] * b[1]
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def _f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _f2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return (a[0] * d % P, -a[1] * d % P)


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        if (y1[0] + y2[0]) % P == 0 and (y1[1] + y2[1]) % P == 0:
            return None
        x1sq = _f2_mul(x1, x1)
        lam = _f2_mul((3 * x1sq[0], 3 * x1sq[1]),
                      _f2_inv((2 * y1[0], 2 * y1[1])))
    else:
        lam = _f2_mul(_f2_sub(y2, y1), _f2_inv(_f2_sub(x2, x1)))
    x3 = _f2_sub(_f2_sub(_f2_mul(lam, lam), x1), x2)
    return (x3, _f2_sub(_f2_mul(lam, _f2_sub(x1, x3)), y1))


def g2_mul(k: int, p):
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_add(p, p)
        k >>= 1
    return acc
