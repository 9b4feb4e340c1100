"""In-circuit fixed-base scalar-mul gadget over the embedded curve.

Frozen for the benchmark's reference (``zkbench/ref``): it imports nothing
of the port, and later changes to the port do not reach it.

The port's copy of ``tpu_zkpool/groth16/gadgets.py`` (host code).

The reference withdraw circuit CONSTRAINS ``sk * G == (owner_x, owner_y)``
via ``std::embedded_curve_ops::fixed_base_scalar_mul`` (the reference's
``noir_circuit/src/main.nr:55-63``), and the generated audit circuit does
the same (``scripts/generate_audit.py:417-422``); this gadget is that
constraint in R1CS.

Construction (standard incomplete-affine double-and-add with an
unknown-discrete-log offset):

- scalar = lo + 2^128 * hi; both limbs bit-decomposed (128 bits each).
- acc starts at a nothing-up-my-sleeve offset point S (derived by
  try-and-increment from a hash seed, so no one knows log_G(S)); each bit i
  conditionally adds the precomputed constant 2^i * G with incomplete
  affine addition (3 constraints) + a 2-constraint select; the final
  result subtracts S with one more incomplete add.
- Incomplete addition is sound here: a degenerate x1 == x2 case requires
  acc = +-(2^i G), i.e. knowledge of log_G(S); the group sum automatically
  reduces mod the curve order, matching ACVM blackbox semantics. scalar = 0
  (mod order) is unsatisfiable rather than "infinity" — the reference
  circuit consumes (x, y) directly so that case is invalid there too.

The gadget is duck-typed over any builder exposing ``aux(fn) -> var``,
``constrain(a, b, c)`` (rank-1 rows as {var: coeff} dicts, var 0 = 1) —
both ``groth16.builder.CircuitBuilder`` and the ACIR converter adapter in
``groth16.r1cs`` qualify.
"""

from __future__ import annotations

import functools
import hashlib

from zkbench.ref.bn254 import (
    FR_MOD as R, EMBEDDED_B, EMBEDDED_GX, EMBEDDED_GY,
)

LIMB_BITS = 128


# --------------------------------------------------------------- host curve


def _aff_add(p, q):
    """Incomplete affine addition on y^2 = x^3 + b over Fr (p != +-q)."""
    (x1, y1), (x2, y2) = p, q
    assert x1 != x2, "degenerate incomplete addition"
    lam = (y2 - y1) * pow(x2 - x1, -1, R) % R
    x3 = (lam * lam - x1 - x2) % R
    y3 = (lam * (x1 - x3) - y1) % R
    return x3, y3


def _aff_dbl(p):
    x1, y1 = p
    lam = 3 * x1 * x1 * pow(2 * y1, -1, R) % R
    x3 = (lam * lam - 2 * x1) % R
    y3 = (lam * (x1 - x3) - y1) % R
    return x3, y3


def _sqrt_mod_r(a: int):
    """Tonelli-Shanks square root mod R (R - 1 = 2^28 * odd); None if NQR."""
    if a == 0:
        return 0
    if pow(a, (R - 1) // 2, R) != 1:
        return None
    q, s = R - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 5  # 5 is a quadratic non-residue mod BN254 Fr
    assert pow(z, (R - 1) // 2, R) == R - 1
    m, c, t, rt = s, pow(z, q, R), pow(a, q, R), pow(a, (q + 1) // 2, R)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % R
            i += 1
        b = pow(c, 1 << (m - i - 1), R)
        m, c = i, b * b % R
        t = t * c % R
        rt = rt * b % R
    return rt


@functools.lru_cache(maxsize=None)
def _tables():
    """(powers [2^i * G for i in 0..255], offset point S with unknown DL)."""
    g = (EMBEDDED_GX, EMBEDDED_GY)
    pows = [g]
    for _ in range(255):
        pows.append(_aff_dbl(pows[-1]))
    seed = int.from_bytes(
        hashlib.sha256(b"tpu_zkpool/fixed-base-offset/v1").digest(), "big") % R
    x = seed
    while True:
        rhs = (x * x % R * x + EMBEDDED_B) % R
        y = _sqrt_mod_r(rhs)
        if y is not None and y != 0:
            break
        x = (x + 1) % R
    return pows, (x, min(y, R - y))


# ------------------------------------------------------------ lc utilities


def _lc(*terms) -> dict:
    out = {}
    for t in terms:
        if isinstance(t, int):
            out[0] = (out.get(0, 0) + t) % R
        else:
            c, v = t
            out[v] = (out.get(v, 0) + c) % R
    return out


def _lc_sub(a: dict, b: dict) -> dict:
    out = dict(a)
    for v, c in b.items():
        out[v] = (out.get(v, 0) - c) % R
    return out


def _lc_const(l: dict):
    """The constant value if the lc has no variable terms, else None."""
    if all(v == 0 for v in l):
        return l.get(0, 0) % R
    return None


def _eval(l: dict, w) -> int:
    return sum(c * w[v] for v, c in l.items()) % R


# ---------------------------------------------------------------- gadget


def _add_const_point(cb, acc, t):
    """acc (lc pair) + constant affine point t -> new lc pair (3 rows)."""
    ax, ay = acc
    tx, ty = t

    def lam_fn(w, ax=dict(ax), ay=dict(ay), tx=tx, ty=ty):
        x1, y1 = _eval(ax, w), _eval(ay, w)
        return (ty - y1) * pow(tx - x1, -1, R) % R

    lam = cb.aux(lam_fn)
    cb.constrain({lam: 1}, _lc_sub(_lc(tx), ax), _lc_sub(_lc(ty), ay))

    def x3_fn(w, ax=dict(ax), lam=lam, tx=tx):
        l = w[lam]
        return (l * l - _eval(ax, w) - tx) % R

    x3 = cb.aux(x3_fn)
    cb.constrain({lam: 1}, {lam: 1},
                 _lc((1, x3), tx, *((c, v) for v, c in ax.items())))

    def y3_fn(w, ax=dict(ax), ay=dict(ay), lam=lam, x3=x3):
        return (w[lam] * (_eval(ax, w) - w[x3]) - _eval(ay, w)) % R

    y3 = cb.aux(y3_fn)
    cb.constrain({lam: 1}, _lc_sub(ax, {x3: 1}),
                 _lc((1, y3), *((c, v) for v, c in ay.items())))
    return ({x3: 1}, {y3: 1})


def _select(cb, bit, new, old):
    """bit ? new : old for lc pairs (2 rows)."""
    out = []
    for n, o in zip(new, old):
        def sel_fn(w, bit=bit, n=dict(n), o=dict(o)):
            return _eval(n, w) if w[bit] else _eval(o, w)

        v = cb.aux(sel_fn)
        cb.constrain({bit: 1}, _lc_sub(n, o), _lc_sub({v: 1}, o))
        out.append({v: 1})
    return tuple(out)


def _bits(cb, x: dict, n: int) -> list:
    bit_vars = []
    for i in range(n):
        b = cb.aux(lambda w, x=dict(x), i=i: (_eval(x, w) >> i) & 1)
        cb.constrain({b: 1}, {b: 1}, {b: 1})
        bit_vars.append(b)
    # sum 2^i b_i == x  (n < 254 so the sum cannot wrap mod R)
    row = _lc(*[(pow(2, i, R), b) for i, b in enumerate(bit_vars)])
    cb.constrain(_lc_sub(row, x), {0: 1}, {})
    return bit_vars


def fixed_base_scalar_mul_gadget(cb, lo: dict, hi: dict, out_x: dict,
                                 out_y: dict):
    """Constrain (out_x, out_y) == (lo + 2^128 * hi) * G on the embedded
    curve. lo/hi/out_x/out_y are lc dicts ({var: coeff}, var 0 = const 1).

    Matches ACVM ``multi_scalar_mul`` fixed-base semantics
    (``noir_circuit/src/main.nr:60``). Adds ~5 rows per scalar bit; constant
    limbs (e.g. hi = 0) cost only their set bits.
    """
    pows, S = _tables()
    acc = (_lc(S[0]), _lc(S[1]))
    acc_pt = S  # tracked only for constant-bit additions

    bit_plan = []  # (kind, payload, table index)
    for limb, off in ((lo, 0), (hi, LIMB_BITS)):
        const = _lc_const(limb)
        if const is not None:
            assert const < (1 << LIMB_BITS)
            for i in range(LIMB_BITS):
                if (const >> i) & 1:
                    bit_plan.append(("const", None, off + i))
        else:
            bvs = _bits(cb, limb, LIMB_BITS)
            for i, b in enumerate(bvs):
                bit_plan.append(("var", b, off + i))

    for kind, b, idx in bit_plan:
        added = _add_const_point(cb, acc, pows[idx])
        if kind == "const":
            acc = added
            if acc_pt is not None:
                acc_pt = _aff_add(acc_pt, pows[idx])
        else:
            acc = _select(cb, b, added, acc)
            acc_pt = None

    # subtract the offset: result = acc + (-S)
    res = _add_const_point(cb, acc, (S[0], R - S[1]))
    cb.constrain(_lc_sub(res[0], out_x), {0: 1}, {})
    cb.constrain(_lc_sub(res[1], out_y), {0: 1}, {})
