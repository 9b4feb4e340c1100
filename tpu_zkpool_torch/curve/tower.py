"""Batched Fp2 / Fp12 tower arithmetic on ``FieldCtx`` limbs.

The port of ``tpu_zkpool/curve/tower.py``. Elements are tensors that
broadcast over leading batch axes:

- Fp2 = Fp[u]/(u^2 + 1): int64[..., 2, 16], (c0, c1) Montgomery limbs;
- Fp12 = Fp2[w]/(w^6 - xi), xi = 9 + u: int64[..., 12, 16], row 2 i + c
  the component c of the coefficient of w^i (the JAX order of a flattened
  Fp12 tuple, and the layout of the pairing kernels, ``csrc/pairing.cu``).
  ``f12_coeffs`` views it as [..., 6, 2, 16].

The JAX ``f12_mul`` accumulates its partial products lazily in 33-bit
columns (``FP.mul_cols`` / ``reduce_cols``); the port's ``FieldCtx`` has no
such form, so it computes the same canonical values with ``mont_mul``. A
``FieldCtx`` call costs about the same at any small batch (~0.3 ms a product
on a CPU), so every op stacks its independent Fp products into one call:
an Fp12 product is one ``mont_mul`` of 108 products a batch element (36
Karatsuba Fp2 products), then a few stacked additions. This module is the
plain version of the pairing kernels P1 and P2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.fields.limbs import int_to_limbs

# ------------------------------------------------------------------- Fp2


def _c(a, i):
    return a[..., i, :]


def _stack(*xs):
    return torch.stack(torch.broadcast_tensors(*xs), dim=-2)


def f2_add(a, b):
    return FP.add(a, b)


def f2_sub(a, b):
    return FP.sub(a, b)


def f2_neg(a):
    return FP.neg(a)


def f2_conj(a):
    return _stack(_c(a, 0), FP.neg(_c(a, 1)))


def f2_mul(a, b):
    """(a0 + a1 u)(b0 + b1 u), Karatsuba: the three Fp products of every
    batch element in one ``mont_mul``."""
    a, b = torch.broadcast_tensors(a, b)
    s = FP.add(torch.stack([_c(a, 0), _c(b, 0)]),
               torch.stack([_c(a, 1), _c(b, 1)]))
    x = torch.stack([_c(a, 0), _c(a, 1), s[0]])
    y = torch.stack([_c(b, 0), _c(b, 1), s[1]])
    t = FP.mont_mul(x, y)                          # a0 b0, a1 b1, (..)(..)
    d = FP.sub(t[[0, 2]], t[[1, 0]])               # t0 - t1, t2 - t0
    return _stack(d[0], FP.sub(d[1], t[1]))


def f2_sqr(a):
    # (a0 + a1)(a0 - a1) + 2 a0 a1 u
    s = FP.add(_c(a, 0), _c(a, 1))
    d = FP.sub(_c(a, 0), _c(a, 1))
    t = FP.mont_mul(torch.stack([s, _c(a, 0)]), torch.stack([d, _c(a, 1)]))
    return _stack(t[0], FP.add(t[1], t[1]))


def f2_scalar_small(a, k: int):
    """k*a for a small non-negative int k (repeated doubling)."""
    acc = None
    base = a
    while k:
        if k & 1:
            acc = base if acc is None else f2_add(acc, base)
        base = f2_add(base, base)
        k >>= 1
    return acc


def f2_mul_by_xi(a):
    """a * (9 + u) = (9 a0 - a1) + (a0 + 9 a1) u."""
    a9 = f2_scalar_small(a, 9)
    return _stack(FP.sub(_c(a9, 0), _c(a, 1)), FP.add(_c(a, 0), _c(a9, 1)))


def f2_inv(a):
    sq = FP.mont_mul(a, a)
    di = FP.inv(FP.add(_c(sq, 0), _c(sq, 1)))
    t = FP.mont_mul(a, di.unsqueeze(-2))
    return _stack(_c(t, 0), FP.neg(_c(t, 1)))


def f2_zero(shape=(), device=None):
    return torch.zeros(tuple(shape) + (2, 16), dtype=torch.int64,
                       device=resolve_device(device))


def f2_one(shape=(), device=None):
    device = resolve_device(device)
    return _stack(FP.ones_mont(shape, device),
                  torch.zeros(tuple(shape) + (16,), dtype=torch.int64,
                              device=device))


def f2_is_zero(a):
    return FP.is_zero(_c(a, 0)) & FP.is_zero(_c(a, 1))


# ------------------------------------------------------------------ Fp12


def f12_coeffs(a):
    """[..., 12, 16] -> the six Fp2 coefficients [..., 6, 2, 16] (a view)."""
    return a.unflatten(-2, (6, 2))


def f12_join(c):
    """[..., 6, 2, 16] Fp2 coefficients -> an Fp12 [..., 12, 16]."""
    return c.flatten(-3, -2)


def f12_one(shape=(), device=None):
    device = resolve_device(device)
    out = torch.zeros(tuple(shape) + (12, 16), dtype=torch.int64,
                      device=device)
    out[..., 0, :] = FP.ones_mont((), device)
    return out


_ODD = [2, 3, 6, 7, 10, 11]      # the rows of w^1, w^3, w^5


def f12_conj(a):
    """Negate the odd coefficients of w (the p^6 Frobenius)."""
    out = a.clone()
    out[..., _ODD, :] = FP.neg(a[..., _ODD, :])
    return out


@functools.lru_cache(maxsize=None)
def _conv_plan(jpow: tuple):
    """Index plan of a product a * b over w where b has coefficients at the
    w-powers ``jpow``: the pair (i, j) of every Fp2 product, and for each
    power m = i + j (0 .. 10) the slots of its terms, padded to equal
    length with a zero slot (index n_pairs)."""
    pairs = [(i, j) for i in range(6) for j in range(len(jpow))]
    by_m = [[] for _ in range(11)]
    for k, (i, j) in enumerate(pairs):
        by_m[i + jpow[j]].append(k)
    width = max(len(t) for t in by_m)
    slots = [t + [len(pairs)] * (width - len(t)) for t in by_m]
    ai = [i for i, _ in pairs]
    bj = [j for _, j in pairs]
    return ai, bj, slots


def _f12_conv(a, b, jpow: tuple):
    """a * (sum_j b_j w^jpow[j]) for Fp12 a [..., 12, 16] and Fp2
    coefficients b [..., J, 2, 16]: every Fp2 product in one ``f2_mul``,
    each power's terms summed by halving stacked additions, then w^6 = xi
    folds powers 6 .. 10."""
    ai, bj, slots = _conv_plan(tuple(jpow))
    a = f12_coeffs(a)
    shape = torch.broadcast_shapes(a.shape[:-3], b.shape[:-3])
    a = a.expand(shape + a.shape[-3:])
    b = b.expand(shape + b.shape[-3:])
    prods = f2_mul(a[..., ai, :, :], b[..., bj, :, :])
    prods = torch.cat([prods, torch.zeros_like(prods[..., :1, :, :])], -3)
    idx = torch.as_tensor(slots, device=a.device)          # (11, width)
    terms = prods[..., idx, :, :]                  # [..., 11, width, 2, 16]
    while terms.shape[-3] > 1:
        h = terms.shape[-3] // 2
        s = FP.add(terms[..., :h, :, :], terms[..., h:2 * h, :, :])
        terms = torch.cat([s, terms[..., 2 * h:, :, :]], -3)
    sums = terms[..., 0, :, :]                     # [..., 11, 2, 16]
    low = sums[..., :6, :, :]
    high = f2_mul_by_xi(sums[..., 6:, :, :])       # powers 6 .. 10
    return f12_join(torch.cat([FP.add(low[..., :5, :, :], high),
                               low[..., 5:, :, :]], -3))


_DENSE = (0, 1, 2, 3, 4, 5)
_LINE = (0, 1, 3)


def f12_mul(a, b):
    """Schoolbook over w: the 36 Fp2 products in one call."""
    return _f12_conv(a, f12_coeffs(b), _DENSE)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_mul_sparse_line(f, l0, l1, l3):
    """f * (l0 + l1 w + l3 w^3), the Miller-loop line shape: 18 Fp2
    products (the JAX form multiplies the dense 36)."""
    return _f12_conv(f, torch.stack(torch.broadcast_tensors(l0, l1, l3), -3),
                     _LINE)


def f12_eq_one(a):
    one = f12_one((), a.device)
    return (a == one).flatten(-2).all(-1)


def f12_from_ints(vals, device=None) -> torch.Tensor:
    """Host Fp12 values (6 Fp2 int pairs each, ``pairing_ref`` layout) ->
    Montgomery limbs int64[n, 12, 16]."""
    arr = np.asarray([[x for c in v for x in c] for v in vals], dtype=object)
    return torch.as_tensor(FP.to_mont(arr.reshape(len(vals), 12)),
                           device=resolve_device(device))


def f12_to_ints(a) -> list:
    """Montgomery limbs [n, 12, 16] -> host Fp12 values."""
    v = FP.from_mont(a)
    return [tuple((int(row[2 * i]), int(row[2 * i + 1])) for i in range(6))
            for row in v]


def f2_const(x, device=None) -> torch.Tensor:
    """A host Fp2 constant -> Montgomery limbs int64[2, 16]."""
    return torch.as_tensor(np.stack([int_to_limbs(int(v) * (1 << 256)
                                                  % FP.modulus)
                                     for v in x]),
                           device=resolve_device(device))
