"""The lane programs of the pairing kernels P1 and P2 (``csrc/pairing.cu``).

P1 and P2 run one warp a batch element. Every Fp12 operation they use (the
Miller loop's square and line product; the final exponentiation's product,
cyclotomic square, Frobenius maps, conjugate and inverse) is compiled here,
once, from its formula over Fp into a short program of steps, each run by
the 32 lanes of the warp at once:

- ``MUL``: lane k computes one Montgomery product x_k y_k, where x_k and y_k
  are integer combinations of slots (Karatsuba's sums);
- ``LIN``: lane k computes one integer combination of slots (the
  recombination: Karatsuba's differences, the products by xi, each output
  coefficient);
- ``INV``: lane k inverts one combination (field.cuh's constant-time
  safegcd; 0 maps to 0).

A slot is one Fp value (8 words, Montgomery, canonical) in the warp's
shared memory. A step's products or combinations are independent, so a
lane computes one of them and the step ends with ``__syncwarp``: an Fp12
product's 54 Fp products take two steps where one thread took 54 in a row.

A step costs about as much as its slowest lane: one product, plus the
latency of its combinations, about a term more for each. So the formulas
are chosen for few steps first, then for short combinations: the Fp12
product is Karatsuba over Fp6 and Fp2 (54 products, two MUL steps); the
square is schoolbook over w with Fp2 squares of single slots and Karatsuba
cross products (63, two steps, each output a few Fp2 products); the line
product, the cyclotomic square (Granger-Scott) and the Frobenius maps use
schoolbook Fp2 products, whose operands are single slots (a ``unit`` MUL
step skips the combination); the inverse is the even-subalgebra one of
``pairing_jax.f12_inv``. Each computes the plain version's field
element (``curve/pairing.py`` over ``curve/tower.py``), and every value is
canonical, so the limbs agree. Products by zero are dropped, products by 1
are not made, and equal products (up to sign and an integer factor) are
made once. An output of more than ``SPLIT`` terms is summed by two lanes in
halves first, where the lanes are idle.

Slots of a warp: ``A`` (12, operand a and the result), ``B`` (12, operand
b), ``L`` (6, a line: alpha_neg's two components, beta's two, px, py),
``K`` (36, the Frobenius gammas of ``kGamma`` in the kernel, flat), then
the temporaries. The blob the kernels read (uint32):

    word 0                 the first slot after every program's temporaries
    word 1                 FORMAT (the kernels trap on another word)
    word 2 + i             offset of program OPS[i]
    program                n steps, then the steps
    step                   kind | nA << 8 | nB << 16 | unit << 24 (unit:
                           a MUL step whose operands are one slot each);
                           dst[32] (a slot, or NO_DST: nothing stored);
                           termsA[nA][32]; termsB[nB][32] (term j of lane
                           k at j * 32 + k)
    term                   slot | |coefficient| << 16 | (coefficient < 0)
                           << 31

Lanes without work read slot 0 with coefficient 0 and store nothing. The
kernel adds ``2^BIAS_LOG2 p`` to a combination before reducing it, so a
lane's sum of |coefficients| stays below ``2^BIAS_LOG2`` (checked here).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from tpu_zkpool_torch.refimpl import pairing_ref as pr

LANES = 32
MUL, LIN, INV = range(3)
A, B, L, K = 0, 12, 24, 30
T0 = K + 36
NO_DST = 0xFFFF
FORMAT = 0x7A6B0001     # the blob's format word: change it with the format
BIAS_LOG2 = 15
SPLIT = 16      # an output of more terms is summed in two halves first
OPS = ("sqr", "line", "mul", "cyclo", "frob1", "frob2", "frob3", "conj",
       "inv")


class E:
    """A symbolic Fp value: an integer combination {atom: coefficient} of
    input slots (atoms below ``T0``) and computed values (the others)."""
    __slots__ = ("t",)

    def __init__(self, t=None):
        self.t = t or {}

    def __add__(self, o):
        d = dict(self.t)
        for a, c in o.t.items():
            v = d.get(a, 0) + c
            if v:
                d[a] = v
            else:
                d.pop(a, None)
        return E(d)

    def __neg__(self):
        return E({a: -c for a, c in self.t.items()})

    def __sub__(self, o):
        return self + (-o)

    def __mul__(self, k: int):
        return E({a: c * k for a, c in self.t.items()}) if k else E()

    def key(self):
        """(the combination divided by its content, the content): the
        content is the gcd of the coefficients, signed like the first."""
        items = sorted(self.t.items())
        g = math.gcd(*(c for _, c in items))
        g = g if items[0][1] > 0 else -g
        return tuple((a, c // g) for a, c in items), g


def _slot(s):
    return E({s: 1})


class _Graph:
    """Records the products, combinations and inverses of one program."""

    def __init__(self):
        self.nodes = []          # (kind, form a, form b or None)
        self.memo = {}

    def _node(self, kind, a, b=None):
        key = (kind, a, b)
        if key not in self.memo:
            self.memo[key] = T0 + len(self.nodes)
            self.nodes.append(key)
        return self.memo[key]

    def mul(self, x: E, y: E) -> E:
        if not x.t or not y.t:
            return E()
        (kx, gx), (ky, gy) = x.key(), y.key()
        kx, ky = min(kx, ky), max(kx, ky)
        return E({self._node(MUL, kx, ky): gx * gy})

    def mat(self, x: E) -> E:
        """x as one computed value (a LIN step)."""
        if not x.t:
            return x
        k, g = x.key()
        if len(k) == 1 and k[0][1] == 1:
            return x
        return E({self._node(LIN, k): g})

    def inv(self, x: E) -> E:
        k, g = x.key()
        if g != 1:
            raise ValueError("inv: a scaled combination")
        return E({self._node(INV, k): 1})


# ------------------------------------------------------ tower formulas
# Fp2: (c0, c1); Fp6: (a, b, c) over v, v^3 = xi; Fp12: 6 Fp2, w^6 = xi.

def f2_add(x, y):
    return (x[0] + y[0], x[1] + y[1])


def f2_sub(x, y):
    return (x[0] - y[0], x[1] - y[1])


def f2_neg(x):
    return (-x[0], -x[1])


def f2_mul(p, x, y):
    """Karatsuba: 3 Fp products (2 where a component is zero)."""
    t0, t1 = p.mul(x[0], y[0]), p.mul(x[1], y[1])
    t2 = p.mul(x[0] + x[1], y[0] + y[1])
    return (t0 - t1, t2 - t0 - t1)


def f2_mul_sb(p, x, y):
    """Schoolbook: 4 Fp products of single slots (2 by an Fp constant)."""
    return (p.mul(x[0], y[0]) - p.mul(x[1], y[1]),
            p.mul(x[0], y[1]) + p.mul(x[1], y[0]))


def f2_sqr(p, x):
    """(x0 + x1)(x0 - x1) + 2 x0 x1 u: 2 Fp products."""
    return (p.mul(x[0] + x[1], x[0] - x[1]), p.mul(x[0], x[1]) * 2)


def f2_sqr_sb(p, x):
    """x0^2 - x1^2 + 2 x0 x1 u: 3 Fp products of single slots."""
    return (p.mul(x[0], x[0]) - p.mul(x[1], x[1]), p.mul(x[0], x[1]) * 2)


def f2_mul_fp(p, x, s):
    return (p.mul(x[0], s), p.mul(x[1], s))


def f2_mul_xi(x):
    """x (9 + u) = (9 x0 - x1) + (x0 + 9 x1) u."""
    return (x[0] * 9 - x[1], x[0] + x[1] * 9)


def f2_mat(p, x):
    return (p.mat(x[0]), p.mat(x[1]))


def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_mul_v(x):
    return (f2_mul_xi(x[2]), x[0], x[1])


def f6_mul(p, x, y):
    """Karatsuba over Fp2: 6 Fp2 products."""
    v0, v1, v2 = (f2_mul(p, x[i], y[i]) for i in range(3))
    t0 = f2_sub(f2_sub(f2_mul(p, f2_add(x[1], x[2]), f2_add(y[1], y[2])),
                       v1), v2)
    t1 = f2_sub(f2_sub(f2_mul(p, f2_add(x[0], x[1]), f2_add(y[0], y[1])),
                       v0), v1)
    t2 = f2_sub(f2_sub(f2_mul(p, f2_add(x[0], x[2]), f2_add(y[0], y[2])),
                       v0), v2)
    return (f2_add(v0, f2_mul_xi(t0)), f2_add(t1, f2_mul_xi(v2)),
            f2_add(t2, v1))


def _even(x):
    return (x[0], x[2], x[4])


def _odd(x):
    return (x[1], x[3], x[5])


def _join(g, h):
    return [g[0], h[0], g[1], h[1], g[2], h[2]]


def f12_mul(p, x, y):
    """Karatsuba over Fp6: 54 Fp products."""
    g, h, g2, h2 = _even(x), _odd(x), _even(y), _odd(y)
    t0, t1 = f6_mul(p, g, g2), f6_mul(p, h, h2)
    s = f6_mul(p, f6_add(g, h), f6_add(g2, h2))
    return _join(f6_add(t0, f6_mul_v(t1)), f6_sub(f6_sub(s, t0), t1))


def f12_sqr(p, x):
    """Schoolbook over w (w^6 = xi): the 6 squares f_i^2 (3 Fp products of
    single slots each) and the 15 products 2 f_i f_j, i < j (Karatsuba, 3
    each): 63 Fp products, two MUL steps like the complex method's 36, and
    each output a combination of at most 4 Fp2 products."""
    out = [(E(), E()) for _ in range(6)]
    for i in range(6):
        for j in range(i, 6):
            t = f2_sqr_sb(p, x[i]) if i == j else f2_mul(p, x[i], x[j])
            t = t if i == j else f2_add(t, t)
            k = i + j
            out[k % 6] = f2_add(out[k % 6], f2_mul_xi(t) if k >= 6 else t)
    return out


def f12_mul_line(p, f, l0, l1, l3):
    """f (l0 + l1 w + l3 w^3), l0 in Fp: 60 Fp products of single slots
    (schoolbook Fp2 products: two MUL steps either way, and no operand to
    combine)."""
    a = [f2_mul_fp(p, c, l0) for c in f]
    b = [f2_mul_sb(p, c, l1) for c in f]
    c = [f2_mul_sb(p, c, l3) for c in f]
    return [f2_add(a[0], f2_mul_xi(f2_add(b[5], c[3]))),
            f2_add(f2_add(a[1], b[0]), f2_mul_xi(c[4])),
            f2_add(f2_add(a[2], b[1]), f2_mul_xi(c[5])),
            f2_add(f2_add(a[3], b[2]), c[0]),
            f2_add(f2_add(a[4], b[3]), c[1]),
            f2_add(f2_add(a[5], b[4]), c[2])]


def f12_conj(x):
    return [c if i % 2 == 0 else f2_neg(c) for i, c in enumerate(x)]


def _gamma_const(power, i):
    """gamma_power,i as symbolic Fp2 constants: a K slot, or 0."""
    g = pr._gamma(power)[i]
    return tuple(E() if g[c] == 0 else _slot(K + 12 * (power - 1) + 2 * i + c)
                 for c in range(2))


def f12_frobenius(p, x, power):
    """conj^power of each coefficient, times gamma_power,i (gamma_0 = 1)."""
    out = []
    for i, c in enumerate(x):
        c = (c[0], -c[1]) if power % 2 else c
        out.append(c if i == 0 else f2_mul_sb(p, c, _gamma_const(power, i)))
    return out


def f12_cyclotomic_sqr(p, a):
    """Granger-Scott: the pairs (a0, a3), (a1, a4), (a2, a5) are Fp4
    elements, (x + y t)^2 = x^2 + xi y^2 + 2 x y t: 30 Fp products of
    single slots, one MUL step."""
    def fp4_sqr(x, y):
        xy = f2_mul_sb(p, x, y)
        return (f2_add(f2_sqr_sb(p, x), f2_mul_xi(f2_sqr_sb(p, y))),
                f2_add(xy, xy))

    t0, t1 = fp4_sqr(a[0], a[3])
    t2, t3 = fp4_sqr(a[1], a[4])
    t4, t5 = fp4_sqr(a[2], a[5])

    def m2(t, c):        # 3 t - 2 c
        return f2_sub(f2_add(f2_add(t, t), t), f2_add(c, c))

    def p2(t, c):        # 3 t + 2 c
        return f2_add(f2_add(f2_add(t, t), t), f2_add(c, c))

    return [m2(t0, a[0]), p2(f2_mul_xi(t5), a[1]), m2(t2, a[2]),
            p2(t1, a[3]), m2(t4, a[4]), p2(t3, a[5])]


def f12_inv(p, a):
    """a conj(a) = g0 + g1 v + g2 v^2 is even in w; its closed-form Fp6
    inverse, then a^-1 = conj(a) (a conj(a))^-1."""
    c = f12_conj(a)
    n = f12_mul(p, a, c)
    g0, g1, g2 = (f2_mat(p, n[i]) for i in (0, 2, 4))
    c0 = f2_mat(p, f2_sub(f2_sqr(p, g0), f2_mul_xi(f2_mul(p, g1, g2))))
    c1 = f2_mat(p, f2_sub(f2_mul_xi(f2_sqr(p, g2)), f2_mul(p, g0, g1)))
    c2 = f2_mat(p, f2_sub(f2_sqr(p, g1), f2_mul(p, g0, g2)))
    den = f2_mat(p, f2_add(f2_mul(p, g0, c0), f2_mul_xi(
        f2_add(f2_mul(p, g2, c1), f2_mul(p, g1, c2)))))
    ni = p.inv(p.mul(den[0], den[0]) + p.mul(den[1], den[1]))
    di = (p.mul(den[0], ni), -p.mul(den[1], ni))
    z = (E(), E())
    gi = [f2_mat(p, f2_mul(p, ci, di)) for ci in (c0, c1, c2)]
    return f12_mul(p, c, [gi[0], z, gi[1], z, gi[2], z])


def _inputs(base):
    return [(_slot(base + 2 * i), _slot(base + 2 * i + 1)) for i in range(6)]


def _formula(op, p):
    a = _inputs(A)
    if op == "sqr":
        return f12_sqr(p, a)
    if op == "line":
        an0, an1, b0, b1, px, py = (_slot(L + i) for i in range(6))
        l1 = (p.mul(an0, px), p.mul(an1, px))
        return f12_mul_line(p, a, py, l1, (b0, b1))
    if op == "mul":
        return f12_mul(p, a, _inputs(B))
    if op == "cyclo":
        return f12_cyclotomic_sqr(p, a)
    if op.startswith("frob"):
        return f12_frobenius(p, a, int(op[4:]))
    if op == "conj":
        return f12_conj(a)
    if op == "inv":
        return f12_inv(p, a)
    raise ValueError(op)


# ------------------------------------------------------------ compiler

def _atoms(form):
    return [a for a, _ in form]


def _compile(op):
    """Schedule one op's nodes into steps (list scheduling by height, up to
    32 of one kind a step), the outputs last (after a step of half sums
    where they are long); allocate temporaries by liveness. Returns (steps,
    the first free slot): a step is (kind, [(dst, termsA, termsB)] one a
    lane)."""
    p = _Graph()
    outs = [c for x in _formula(op, p) for c in x]
    # the output nodes: A + j gets outs[j] unless it is A + j already
    final = [(A + j, sorted(o.t.items())) for j, o in enumerate(outs)
             if o.t != {A + j: 1}]
    node_forms = {T0 + i: [n[1]] + ([n[2]] if n[2] is not None else [])
                  for i, n in enumerate(p.nodes)}
    live, stack = set(), [a for _, f in final for a in _atoms(f) if a >= T0]
    while stack:
        n = stack.pop()
        if n not in live:
            live.add(n)
            stack += [a for f in node_forms[n] for a in _atoms(f) if a >= T0]
    users = {n: [] for n in live}
    for n in live:
        for f in node_forms[n]:
            for a in _atoms(f):
                if a >= T0:
                    users[a].append(n)
    height = {}

    def h(n):
        if n not in height:
            height[n] = 1 + max((h(u) for u in users[n]), default=0)
        return height[n]

    done, steps, order = set(), [], sorted(live)
    while len(done) < len(live):
        ready = [n for n in order if n not in done and all(
            a < T0 or a in done for f in node_forms[n] for a in _atoms(f))]
        best = max(ready, key=h)
        kind = p.nodes[best - T0][0]
        pick = sorted((n for n in ready if p.nodes[n - T0][0] == kind),
                      key=lambda n: (-h(n), n))[:LANES]
        steps.append((kind, pick))
        done |= set(pick)
    # temporaries: a slot frees after the last step that reads it
    last = {}
    for s, (_, pick) in enumerate(steps):
        for n in pick:
            for f in node_forms[n]:
                for a in _atoms(f):
                    last[a] = s
    for _, f in final:
        for a in _atoms(f):
            last[a] = len(steps)
    slot, free, frees = {}, [], {}
    top = [T0]
    for n, s in last.items():
        frees.setdefault(s, []).append(n)

    def alloc():
        if free:
            return free.pop()
        top[0] += 1
        return top[0] - 1

    out = []
    for s, (kind, pick) in enumerate(steps):
        for n in pick:
            slot[n] = alloc()
        out.append((kind, [(slot[n], *[[(slot.get(a, a), c) for a, c in f]
                                       for f in node_forms[n]])
                           for n in pick]))
        free += sorted((slot[n] for n in frees.get(s, []) if n >= T0),
                       reverse=True)
    if final:
        lanes = [(d, [(slot.get(a, a), c) for a, c in f]) for d, f in final]
        if (max(len(t) for _, t in lanes) > SPLIT
                and 2 * len(lanes) <= LANES):
            # long outputs: two lanes a half each, then their sum
            halves, sums = [], []
            for d, terms in lanes:
                h = (len(terms) + 1) // 2
                pair = [alloc(), alloc()]
                halves += [(pair[0], terms[:h]), (pair[1], terms[h:])]
                sums.append((d, [(pair[0], 1), (pair[1], 1)]))
            out.append((LIN, halves))
            lanes = sums
        for d, terms in lanes:      # no lane reads a slot another overwrites
            for d2, _ in lanes:
                if d2 != d and any(s == d2 for s, _ in terms):
                    raise AssertionError(f"{op}: in-place hazard on {d2}")
        out.append((LIN, lanes))
    return out, top[0]


def _pack_step(kind, lanes):
    if len(lanes) > LANES:
        raise AssertionError("a step wider than a warp")
    ta = [ln[1] for ln in lanes]
    tb = [ln[2] if len(ln) > 2 else [] for ln in lanes]
    for terms in ta + tb:
        if sum(abs(c) for _, c in terms) >= 1 << BIAS_LOG2:
            raise AssertionError("coefficients above the kernel's bias")
    na = max(len(t) for t in ta)
    nb = max(len(t) for t in tb) if kind == MUL else 0
    words = np.zeros(1 + LANES * (1 + na + nb), np.uint32)
    unit = kind == MUL and all(len(t) == 1 and t[0][1] == 1 for t in ta + tb)
    words[0] = kind | na << 8 | nb << 16 | unit << 24
    words[1:1 + LANES] = NO_DST
    for k, ln in enumerate(lanes):
        words[1 + k] = ln[0]
        for base, terms in ((1 + LANES, ta[k]),
                            (1 + LANES * (1 + na), tb[k])):
            for j, (s, c) in enumerate(terms):
                words[base + LANES * j + k] = s | abs(c) << 16 | (c < 0) << 31
    return words


@functools.lru_cache(maxsize=None)
def program() -> np.ndarray:
    """The blob of every program of ``OPS`` (uint32, the module's format)."""
    progs, top = [], T0
    for op in OPS:
        steps, t = _compile(op)
        top = max(top, t)
        progs.append(np.concatenate(
            [np.asarray([len(steps)], np.uint32)]
            + [_pack_step(kind, lanes) for kind, lanes in steps]))
    head = np.zeros(2 + len(OPS), np.uint32)
    head[0], head[1] = top, FORMAT
    off = len(head)
    for i, pg in enumerate(progs):
        head[2 + i] = off
        off += len(pg)
    return np.concatenate([head] + progs)
