"""Pure-Python BN254 (alt_bn128) optimal-ate pairing (host code).

A copy of ``tpu_zkpool.refimpl.pairing_ref`` for the PyTorch port. It is the
pairing gnark's Groth16 verifier uses:
Fp2 = Fp[u]/(u^2+1), Fp12 = Fp2[w]/(w^6 - xi) with xi = 9 + u, D-type twist
E': y^2 = x^3 + 3/xi, Miller loop over 6x+2, Frobenius end-steps, and final
exponentiation (naive big-exponent, easy to audit).

Validated by bilinearity/non-degeneracy properties and by verifying
self-generated Groth16 proofs against gnark-format artifacts.
"""

from __future__ import annotations

import random

from tpu_zkpool_torch.fields.bn254 import FP_MOD as P, FR_MOD as R_ORDER, BN_X, G2_GX, G2_GY

# ----------------------------------------------------------------- Fp2

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)

def f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)

def f2_sqr(a):
    return f2_mul(a, a)

def f2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)

def f2_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return (a[0] * d % P, (-a[1]) * d % P)

def f2_conj(a):
    return (a[0], (-a[1]) % P)

def f2_sqrt(a):
    """A square root of a in Fp2 = Fp[i]/(i^2 + 1) (p = 3 mod 4), or None:
    from the norm's root s, x0^2 = (a0 +- s)/2 and x1 = a1 / (2 x0)."""
    u, v = a[0] % P, a[1] % P
    n = (u * u + v * v) % P
    s = pow(n, (P + 1) // 4, P)
    if s * s % P != n:
        return None
    half = (P + 1) // 2
    for t in ((u + s) * half % P, (u - s) * half % P):
        x0 = pow(t, (P + 1) // 4, P)
        if x0 and x0 * x0 % P == t:
            root = (x0, v * pow(2 * x0, -1, P) % P)
            if f2_sqr(root) == (u, v):
                return root
    return None

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # the sextic non-residue

# ----------------------------------------------------------------- Fp12
# Elements are 6-tuples of Fp2 coeffs: a = sum_i c_i w^i, w^6 = XI.

F12_ZERO = (F2_ZERO,) * 6
F12_ONE = (F2_ONE,) + (F2_ZERO,) * 5


def f12_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f12_mul(a, b):
    res = [F2_ZERO] * 11
    for i in range(6):
        if a[i] == F2_ZERO:
            continue
        for j in range(6):
            if b[j] == F2_ZERO:
                continue
            res[i + j] = f2_add(res[i + j], f2_mul(a[i], b[j]))
    out = list(res[:6])
    for k in range(6, 11):
        out[k - 6] = f2_add(out[k - 6], f2_mul(res[k], XI))
    return tuple(out)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_conj(a):
    """Conjugation = Frobenius^6: negate odd w-coefficients."""
    return tuple(c if i % 2 == 0 else f2_neg(c) for i, c in enumerate(a))


def f12_inv(a):
    """Inverse via solving with the w^6 = xi structure: use resultant-free
    approach — invert by exponentiation is slow; use the tower trick:
    treat Fp12 = Fp6[w]/(w^2 - v). Implemented via linear algebra over Fp2."""
    # Build the 6x6 multiplication matrix of a over basis w^0..w^5 and solve
    # a * x = 1. Entries are Fp2. Gaussian elimination over Fp2.
    M = [[F2_ZERO] * 6 for _ in range(6)]
    for j in range(6):  # column j: a * w^j
        col = [F2_ZERO] * 11
        for i in range(6):
            col[i + j] = a[i]
        red = list(col[:6])
        for k in range(6, 11):
            red[k - 6] = f2_add(red[k - 6], f2_mul(col[k], XI))
        for i in range(6):
            M[i][j] = red[i]
    # solve M x = e0
    rhs = [F2_ONE] + [F2_ZERO] * 5
    # forward elimination
    for col in range(6):
        piv = next(r for r in range(col, 6) if M[r][col] != F2_ZERO)
        M[col], M[piv] = M[piv], M[col]
        rhs[col], rhs[piv] = rhs[piv], rhs[col]
        inv = f2_inv(M[col][col])
        M[col] = [f2_mul(v, inv) for v in M[col]]
        rhs[col] = f2_mul(rhs[col], inv)
        for r in range(6):
            if r != col and M[r][col] != F2_ZERO:
                f = M[r][col]
                M[r] = [f2_sub(v, f2_mul(f, w)) for v, w in zip(M[r], M[col])]
                rhs[r] = f2_sub(rhs[r], f2_mul(f, rhs[col]))
    return tuple(rhs)


def f12_pow(a, e: int):
    result = F12_ONE
    base = a
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sqr(base)
        e >>= 1
    return result


# ------------------------------------------------ fast final exponentiation
#
# Easy part f^((p^6-1)(p^2+1)) puts f in the cyclotomic subgroup, where
# squaring has the cheap Granger-Scott form and the hard part
# (p^4 - p^2 + 1)/r evaluates through the Scott-et-al. vectorial addition
# chain (3 exponentiations by the curve parameter x + ~13 multiplications)
# instead of a blind 3000-bit square-and-multiply. This is the algorithm
# class gnark's verifier uses behind the reference's verifier programs
# (``audit_circuit/target/audit_verifier.so``).


def _gamma(power: int):
    """xi^(i*(p^power - 1)/6) for i = 0..5 — Frobenius^power coefficients."""
    return tuple(_f2_pow(XI, i * (P ** power - 1) // 6) for i in range(6))


def f12_frobenius(a, power: int, _cache={}):
    """a^(p^power) on flat w-coefficients: conj^power per Fp2 coefficient,
    times xi^(i*(p^power-1)/6) (since w^(p^k) = w * xi^((p^k-1)/6))."""
    if power not in _cache:
        _cache[power] = _gamma(power)
    g = _cache[power]
    out = []
    for i in range(6):
        c = f2_conj(a[i]) if power % 2 else a[i]
        out.append(f2_mul(c, g[i]))
    return tuple(out)


def f12_cyclotomic_sqr(a):
    """Granger-Scott squaring, valid for elements of the cyclotomic
    subgroup (i.e. after the easy part). Fp4 = Fp2[w^3]/((w^3)^2 - xi):
    the pairs (a0,a3), (a1,a4), (a2,a5) are Fp4 elements."""
    def fp4_sqr(x, y):
        # (x + y*t)^2, t^2 = xi: (x^2 + xi y^2, 2xy)
        x2 = f2_sqr(x)
        y2 = f2_sqr(y)
        return (f2_add(x2, f2_mul(y2, XI)),
                f2_sub(f2_sub(f2_sqr(f2_add(x, y)), x2), y2))

    t0, t1 = fp4_sqr(a[0], a[3])
    t2, t3 = fp4_sqr(a[1], a[4])
    t4, t5 = fp4_sqr(a[2], a[5])
    # z0 = 3 t0 - 2 a0 ; z2 = 3 t2 - 2 a2? (verified vs f12_sqr in tests)
    def three_minus_two(t, c):
        return f2_sub(f2_add(f2_add(t, t), t), f2_add(c, c))

    def three_plus_two(t, c):
        return f2_add(f2_add(f2_add(t, t), t), f2_add(c, c))

    z0 = three_minus_two(t0, a[0])
    z1 = three_plus_two(f2_mul(t5, XI), a[1])
    z2 = three_minus_two(t2, a[2])
    z3 = three_plus_two(t1, a[3])
    z4 = three_minus_two(t4, a[4])
    z5 = three_plus_two(t3, a[5])
    return (z0, z1, z2, z3, z4, z5)


def f12_pow_x_cyclo(a):
    """a^BN_X in the cyclotomic subgroup (cyclotomic squarings)."""
    result = None
    base = a
    e = BN_X
    while e:
        if e & 1:
            result = base if result is None else f12_mul(result, base)
        base = f12_cyclotomic_sqr(base)
        e >>= 1
    return result


def final_exponentiation_fast(f):
    """f^((p^12-1)/r) via easy part + Scott et al. hard-part chain."""
    # easy part: f^(p^6-1), then ^(p^2+1)
    m = f12_mul(f12_conj(f), f12_inv(f))
    m = f12_mul(f12_frobenius(m, 2), m)
    # hard part on the cyclotomic element m
    fx = f12_pow_x_cyclo(m)
    fx2 = f12_pow_x_cyclo(fx)
    fx3 = f12_pow_x_cyclo(fx2)
    y0 = f12_mul(f12_mul(f12_frobenius(m, 1), f12_frobenius(m, 2)),
                 f12_frobenius(m, 3))
    y1 = f12_conj(m)
    y2 = f12_frobenius(fx2, 2)
    y3 = f12_conj(f12_frobenius(fx, 1))
    y4 = f12_conj(f12_mul(fx, f12_frobenius(fx2, 1)))
    y5 = f12_conj(fx2)
    y6 = f12_conj(f12_mul(fx3, f12_frobenius(fx3, 1)))
    T0 = f12_cyclotomic_sqr(y6)
    T0 = f12_mul(T0, y4)
    T0 = f12_mul(T0, y5)
    T1 = f12_mul(y3, y5)
    T1 = f12_mul(T1, T0)
    T0 = f12_mul(T0, y2)
    T1 = f12_cyclotomic_sqr(T1)
    T1 = f12_mul(T1, T0)
    T1 = f12_cyclotomic_sqr(T1)
    T0 = f12_mul(T1, y1)
    T1 = f12_mul(T1, y0)
    T0 = f12_cyclotomic_sqr(T0)
    return f12_mul(T0, T1)


# ------------------------------------------------------- G1 / G2 (affine)

def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_mul(k, p):
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_add(p, p)
        k >>= 1
    return acc


TWIST_B = f2_mul((3, 0), f2_inv(XI))  # b' = 3/xi for the D-twist


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_neg(p):
    return None if p is None else (p[0], f2_neg(p[1]))


def g2_mul(k, p):
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_add(p, p)
        k >>= 1
    return acc


def twist_point_outside_g2(seed: int):
    """A point on G2's twist curve y^2 = x^3 + b' with r Q != O: a random
    x until x^3 + b' has a root (the twist's cofactor is large, so such a
    point is outside the order-r subgroup; checked)."""
    rng = random.Random(seed)
    while True:
        x = (rng.randrange(P), rng.randrange(P))
        y = f2_sqrt(f2_add(f2_mul(f2_sqr(x), x), TWIST_B))
        if y is not None and g2_mul(R_ORDER, (x, y)) is not None:
            return (x, y)


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), TWIST_B)) == F2_ZERO


G2_GEN = (G2_GX, G2_GY)

# --------------------------------------------------------------- pairing

# Frobenius coefficients: xi^((p-1)/6) powers for the twisted Frobenius.
_FROB_C1 = pow(9, (P - 1) // 6, P)  # placeholder; real coeff is in Fp2


def _f2_pow(a, e):
    result = F2_ONE
    base = a
    while e:
        if e & 1:
            result = f2_mul(result, base)
        base = f2_sqr(base)
        e >>= 1
    return result


_XI_P_16 = _f2_pow(XI, (P - 1) // 6)   # xi^((p-1)/6)
_XI_P_13 = _f2_pow(XI, (P - 1) // 3)   # xi^((p-1)/3)
_XI_P_12 = _f2_pow(XI, (P - 1) // 2)   # xi^((p-1)/2)


def g2_frobenius(q):
    """pi(x, y) = (x^p * xi^((p-1)/3), y^p * xi^((p-1)/2)) on the twist."""
    x, y = q
    return (f2_mul(f2_conj(x), _XI_P_13), f2_mul(f2_conj(y), _XI_P_12))


def _line(t, q, p1):
    """Line through t, q (G2 points on twist) evaluated at p1 in G1,
    embedded into Fp12 via the twist map (x', y') -> (x' w^2, y' w^3).

    Returns (new_t, line_value in Fp12).
    """
    px, py = p1
    if t == q:
        lam = f2_mul(f2_scalar(f2_sqr(t[0]), 3), f2_inv(f2_scalar(t[1], 2)))
    else:
        lam = f2_mul(f2_sub(q[1], t[1]), f2_inv(f2_sub(q[0], t[0])))
    x3 = f2_sub(f2_sub(f2_sqr(lam), t[0]), q[0] if t != q else t[0])
    y3 = f2_sub(f2_mul(lam, f2_sub(t[0], x3)), t[1])
    new_t = (x3, y3)
    # Embed G2 into the full curve over Fp12 via the D-twist map
    # (x', y') -> (x' w^2, y' w^3); the slope of the embedded line picks up a
    # factor w (dy/dx ~ w^3/w^2). Evaluated at the G1 point (px, py) ⊂ Fp12:
    #   l(P) = py − (lam·px)·w + (lam·x_t − y_t)·w^3
    l = [F2_ZERO] * 6
    l[0] = (py % P, 0)
    l[1] = f2_neg(f2_scalar(lam, px % P))
    l[3] = f2_sub(f2_mul(lam, t[0]), t[1])
    return new_t, tuple(l)


ATE_LOOP = 6 * BN_X + 2


def miller_loop(p1, q2):
    """Optimal ate Miller loop f_{6x+2, Q}(P) with the two Frobenius steps."""
    if p1 is None or q2 is None:
        return F12_ONE
    f = F12_ONE
    t = q2
    bits = bin(ATE_LOOP)[3:]  # skip leading 1
    for b in bits:
        t, l = _line(t, t, p1)
        f = f12_mul(f12_sqr(f), l)
        if b == "1":
            t, l = _line(t, q2, p1)
            f = f12_mul(f, l)
    q1 = g2_frobenius(q2)
    q_2 = g2_neg(g2_frobenius(q1))
    t, l = _line(t, q1, p1)
    f = f12_mul(f, l)
    t, l = _line(t, q_2, p1)
    f = f12_mul(f, l)
    return f


_FINAL_EXP = (P ** 12 - 1) // R_ORDER


def final_exponentiation(f):
    return f12_pow(f, _FINAL_EXP)


def pairing(p1, q2):
    """e(P, Q) for P in G1 (affine int pair), Q in G2 (affine Fp2 pair).

    Uses the cyclotomic-chain final exponentiation (identical value to the
    naive power — ``tests/test_pairing.py`` pins the equality)."""
    return final_exponentiation_fast(miller_loop(p1, q2))
