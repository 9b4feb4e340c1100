"""Reference implementation of the embedded curve y^2 = x^3 - 17 over Fr.

Frozen for the benchmark's reference (``zkbench/ref``): it imports nothing
of the port, and later changes to the port do not reach it.

The port's copy of ``tpu_zkpool/refimpl/curve_ref.py`` (host code).

The reference calls this curve "BabyJubJub" but it is the short-Weierstrass
curve used by Noir's ``std::embedded_curve_ops`` (a = 0, b = -17, base field =
BN254 scalar field) with generator (1, 0x...2cf135e...) — see
``client/merkle.ts:44-75`` and ``noir_circuit/src/main.nr:54-60``.
"""

from __future__ import annotations

from zkbench.ref.bn254 import FR_MOD as P, EMBEDDED_GX, EMBEDDED_GY, EMBEDDED_ORDER

# Affine points as (x, y) tuples; None is the identity.
GEN = (EMBEDDED_GX, EMBEDDED_GY)


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x - 17)) % P == 0


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def scalar_mul(k: int, pt=GEN):
    k %= EMBEDDED_ORDER
    result = None
    acc = pt
    while k:
        if k & 1:
            result = add(result, acc)
        acc = add(acc, acc)
        k >>= 1
    return result
