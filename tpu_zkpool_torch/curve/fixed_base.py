"""Windowed fixed-base scalar multiplication on the device.

The port of ``tpu_zkpool/curve/fixed_base.py``: the equivalent of Noir's
``std::embedded_curve_ops::fixed_base_scalar_mul`` (``noir_circuit/src/
main.nr:60``) and noble-curves' identity keygen (``client/merkle.ts:104``).
A per-base table of window multiples ``T[w][d] = d * 2^(cw) * G`` is
computed once on the host, and a batch of scalars reduces to ``n_windows``
table gathers and batched complete Jacobian adds: no doublings on the scalar
path. The JAX module's ``lax.scan`` over the windows is a Python loop here.

Works for any a = 0 curve handled by ``CurveOps`` (the embedded identity
curve over Fr and BN254 G1 over Fp).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.curve.weierstrass import EMBEDDED, CurveOps


class FixedBaseTable:
    """Host-computed window table for one base point, held on ``device``
    (``cuda`` unless the caller names another)."""

    def __init__(self, curve: CurveOps, base=None, c: int = 8,
                 nbits: int = 256, device=None):
        self.curve = curve
        self.c = c
        self.n_windows = -(-nbits // c)
        self.device = resolve_device(device)
        base = base if base is not None else curve.gen
        rows = 1 << c

        # host table of affine multiples (python ints; O(2^c * W) adds)
        def aff_add(p, q):
            if p is None:
                return q
            if q is None:
                return p
            F = curve.F.modulus
            (x1, y1), (x2, y2) = p, q
            if x1 == x2 and (y1 + y2) % F == 0:
                return None
            if p == q:
                lam = 3 * x1 * x1 * pow(2 * y1, -1, F) % F
            else:
                lam = (y2 - y1) * pow(x2 - x1, -1, F) % F
            x3 = (lam * lam - x1 - x2) % F
            return (x3, (lam * (x1 - x3) - y1) % F)

        table = np.empty((self.n_windows, rows), dtype=object)
        win_base = base
        for w in range(self.n_windows):
            acc = None
            for d in range(rows):
                table[w, d] = acc
                acc = aff_add(acc, win_base)
            for _ in range(c):
                win_base = aff_add(win_base, win_base)
            table[w, 0] = None  # identity
        # device arrays: X/Y Montgomery, Z = R (or 0 for the identity slot)
        xs = [[p[0] if p else 0 for p in row] for row in table]
        ys = [[p[1] if p else 0 for p in row] for row in table]
        zm = torch.as_tensor([[1 if p else 0 for p in row] for row in table],
                             dtype=torch.int64, device=self.device)
        F = curve.F
        self.tx = torch.as_tensor(F.to_mont(np.asarray(xs, dtype=object)),
                                  device=self.device)
        self.ty = torch.as_tensor(F.to_mont(np.asarray(ys, dtype=object)),
                                  device=self.device)
        self.tz = F.ones_mont((self.n_windows, rows), self.device) * zm[..., None]

    def mul(self, digits):
        """[k]base for int64[B, n_windows] window digits (LSB window 0).
        Returns a Jacobian (X, Y, Z) batch, int64[B, 16] each, on the
        table's device: per window one gather and one complete add."""
        digits = torch.as_tensor(digits, device=self.device)
        acc = self.curve.identity((digits.shape[0],), self.device)
        for w in range(digits.shape[1]):
            d = digits[:, w]
            acc = self.curve.add(acc, (self.tx[w, d], self.ty[w, d],
                                       self.tz[w, d]))
        return acc

    def digits(self, ks) -> np.ndarray:
        """Host: int scalars -> int64[B, n_windows] window digits."""
        ks = [int(k) for k in np.asarray(ks, dtype=object).reshape(-1)]
        out = np.zeros((len(ks), self.n_windows), dtype=np.int64)
        mask = (1 << self.c) - 1
        for i, k in enumerate(ks):
            for w in range(self.n_windows):
                out[i, w] = (k >> (self.c * w)) & mask
        return out

    def mul_ints(self, ks):
        return self.mul(self.digits(ks))


@functools.lru_cache(maxsize=None)
def _generator_table(c: int, device: torch.device) -> FixedBaseTable:
    return FixedBaseTable(EMBEDDED, c=c, nbits=256, device=device)


def embedded_generator_table(c: int = 8, device=None) -> FixedBaseTable:
    """The identity-keygen table: sk * G on the embedded curve, one per
    (c, device) (``cuda`` unless the caller names another)."""
    return _generator_table(c, resolve_device(device))
