"""Multi-limb Montgomery field arithmetic over a prime modulus, in torch.

The port of ``tpu_zkpool/fields/fctx.py``. A :class:`FieldCtx` holds the
per-modulus constants and the batched ops. Public ops take and return
``int64[..., 16]`` canonical 16-bit limbs in the Montgomery domain (R =
2^256), broadcasting over leading axes, and give the same limbs as the JAX
``FieldCtx`` on the same values.

Inside, the ops work limb-major (``lm_*``: limbs on axis 0, batch after), so
each limb is one contiguous slice. Every op is a fixed, short sequence of
tensor ops, with no loop over the batch and no limb-by-limb carry chain:

- a carry chain is resolved by :func:`_norm`: split-and-shift passes over
  all limbs at once, as many as the column bound needs, then every ripple
  carry left at once through one packed binary sum (no host read, so no
  device op waits on the host);
- Montgomery multiplication is the three-product form: T = a*b, m = (T mod
  R) * (-p^-1) mod R, (T + m*p) / R, then one conditional subtraction. The
  two constant products are float64 matrix products, exact because every
  column sum stays below 2^53. The low half of T + m*p is a multiple of R,
  so its carry into the high half is read off without resolving it.

The CUDA kernels (``csrc/field.cuh``) compute the same canonical values with
8 x 32-bit words; this module is their plain twin and the host-side field.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch.fields import bn254
from tpu_zkpool_torch.fields.limbs import (MASK, NLIMB, WBITS, int_to_limbs,
                                           ints_to_limbs, limbs_to_ints)

# Batches above this many elements build product columns limb by limb
# instead of through one (16, 32, ...) outer-product buffer.
_OUTER_MAX = 256


def _col(v: torch.Tensor, nd: int) -> torch.Tensor:
    """A (n,) constant shaped to broadcast against (n, *batch) of ``nd`` dims."""
    return v.view((v.shape[0],) + (1,) * (nd - 1))


def _pad1(x: torch.Tensor) -> torch.Tensor:
    """Append one zero limb row (room for a carry out)."""
    return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, 1))


@functools.lru_cache(maxsize=None)
def _shifts(n: int, nd: int, device) -> torch.Tensor:
    """Limb indices 0 .. n-1 shaped (n, 1, ..., 1) to broadcast over nd dims."""
    return torch.arange(n, device=device).view((n,) + (1,) * (nd - 1))


def _norm(x: torch.Tensor, passes: int, wrap: bool = False) -> torch.Tensor:
    """Carry-normalize nonnegative int64 columns (n, *B), n <= 17, into
    canonical 16-bit limbs. The value must fit the n limbs, or ``wrap``
    drops what carries out of the top (reduction mod 2^(16 n)).

    ``passes`` split-and-shift passes bring every column into [0, 2^16] (1
    for columns < 2^17, 3 for columns < 2^37). What is left is a ripple: a
    limb at 2^16 generates a carry (bit i of G), a limb at 2^16 - 1
    propagates one (bit i of P). In the binary sum (G | P) + G every ripple
    resolves at once: the carry into limb i is bit i of ((G | P) + G) ^ P.
    With r = max(x - (2^16 - 2), 0), which is 2 at a generate and 1 at a
    propagate, (G | P) + G = sum_i r_i 2^i and P = sum_i (r_i & 1) 2^i. A
    fixed sequence of tensor ops, so a device tensor never waits on the
    host."""
    x = _passes(x, passes, wrap)
    sh = _shifts(x.shape[0], x.dim(), x.device)
    r = (x - (MASK - 1)).clamp_(min=0)
    carry = ((((r << sh).sum(0) ^ ((r & 1) << sh).sum(0)).unsqueeze(0) >> sh)
             & 1)
    return (x + carry) & MASK


def _passes(x: torch.Tensor, passes: int, wrap: bool = False) -> torch.Tensor:
    for _ in range(passes):
        c = x >> WBITS
        if wrap:
            c[-1] = 0
        x = (x & MASK) + c.roll(1, 0)
    return x


def _cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product columns of limb-major a, b (16, *B) -> (32, *B) int64, column
    k = sum_{i+j=k} a_i b_j < 2^36 (column 31 is zero)."""
    rest = a.shape[1:]
    if a[0].numel() <= _OUTER_MAX:
        skew = a.new_zeros((NLIMB, 2 * NLIMB + 1) + rest)
        skew[:, :NLIMB] = a.unsqueeze(1) * b.unsqueeze(0)
        # row i read with stride 32 lands column j at i + j
        skew = skew.reshape((NLIMB * (2 * NLIMB + 1),) + rest)
        return skew[:NLIMB * 2 * NLIMB].reshape((NLIMB, 2 * NLIMB) + rest).sum(0)
    cols = torch.zeros((2 * NLIMB,) + rest, dtype=torch.int64, device=a.device)
    for i in range(NLIMB):
        cols[i:i + NLIMB] += a[i] * b
    return cols


def _toeplitz(limbs, rows: int) -> np.ndarray:
    """(rows, 16) float64 matrix M with M[k, i] = limbs[k - i]: M @ x gives
    the first ``rows`` product columns of (constant * x)."""
    m = np.zeros((rows, NLIMB), dtype=np.float64)
    for k in range(rows):
        for i in range(NLIMB):
            if 0 <= k - i < NLIMB:
                m[k, i] = float(limbs[k - i])
    return m


class FieldCtx:
    """Montgomery arithmetic context for a prime p < 2^254 (R = 2^256)."""

    def __init__(self, modulus: int, name: str = "F"):
        p = modulus
        assert p % 2 == 1 and p < 1 << (WBITS * NLIMB - 2)
        self.modulus = p
        self.name = name
        R = 1 << (WBITS * NLIMB)
        self.p_limbs = int_to_limbs(p)
        self.n0 = (-pow(p, -1, 1 << WBITS)) % (1 << WBITS)   # -p^-1 mod 2^16
        self.n0_32 = (-pow(p, -1, 1 << 32)) % (1 << 32)      # -p^-1 mod 2^32
        self.r_mod_p = R % p
        self.r2_mod_p = R * R % p
        self.r_inv = pow(R, -1, p)
        self._nprime = int_to_limbs((-pow(p, -1, R)) % R)
        # 2^256 - p and 2^256 over 17 rows, no limb negative after adding
        # the (a - b) limb differences: 2^256 = 2^16 + sum_{i=1}^{15}
        # (2^16 - 1) 2^(16 i).
        self._negp = np.append(int_to_limbs(R - p), 0)
        self._two256 = np.asarray([1 << WBITS] + [MASK] * 15 + [0], np.int64)
        self._consts = {}

    def _c(self, device) -> dict:
        device = torch.device(device)
        c = self._consts.get(device)
        if c is None:
            t = functools.partial(torch.as_tensor, device=device)
            c = dict(
                p=t(self.p_limbs, dtype=torch.int64),
                negp=t(self._negp, dtype=torch.int64),
                two256=t(self._two256, dtype=torch.int64),
                one=t(int_to_limbs(self.r_mod_p), dtype=torch.int64),
                nt=t(_toeplitz(self._nprime, NLIMB)),
                pt=t(_toeplitz(self.p_limbs, 2 * NLIMB)),
            )
            self._consts[device] = c
        return c

    # ---------------------------------------------------------------- host IO

    def to_mont(self, xs) -> np.ndarray:
        """Python ints (any nesting) -> Montgomery limbs int64[..., 16]."""
        xs = np.asarray(xs, dtype=object)
        R = 1 << (WBITS * NLIMB)
        flat = [(int(v) % self.modulus) * R % self.modulus
                for v in xs.reshape(-1)]
        return ints_to_limbs(np.asarray(flat, dtype=object).reshape(xs.shape))

    def from_mont(self, limbs) -> np.ndarray:
        """Montgomery limbs (numpy or torch) -> object ndarray of ints."""
        vals = limbs_to_ints(limbs)
        flat = [int(v) * self.r_inv % self.modulus for v in vals.reshape(-1)]
        return np.asarray(flat, dtype=object).reshape(vals.shape)

    def ones_mont(self, shape, device) -> torch.Tensor:
        """Montgomery 1 (= R mod p) broadcast to ``shape``, on ``device``."""
        return self._c(device)["one"].expand(tuple(shape) + (NLIMB,))

    # ------------------------------------------------ limb-major primitives

    def _cond_sub(self, r):
        """r - p if r >= p else r, for limbs of a value r < 2p."""
        t = _norm(_pad1(r) + _col(self._c(r.device)["negp"], r.dim()), 1)
        return torch.where(t[NLIMB] != 0, t[:NLIMB], r)

    def lm_add(self, a, b):
        return self._cond_sub(_norm(a + b, 1))

    def lm_sub(self, a, b):
        c = self._c(a.device)
        x = _norm(_pad1(a - b) + _col(c["two256"], a.dim()), 1)  # a - b + R
        d = x[:NLIMB]
        t = _norm(d + _col(c["p"], d.dim()), 1, wrap=True)
        return torch.where(x[NLIMB] != 0, d, t)

    def lm_neg(self, a):
        return self.lm_sub(torch.zeros_like(a), a)

    def lm_mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        c = self._c(a.device)
        rest = a.shape[1:]
        # T = a*b, one pass: limbs < 2^21 (not canonical; T's value holds)
        T = _passes(_cols(a, b), 1).reshape(2 * NLIMB, -1)
        m = torch.matmul(c["nt"], T[:NLIMB].double()).long()   # < 2^41
        m = _norm(m, 3, wrap=True)                             # T*n' mod R
        U = _passes(T + torch.matmul(c["pt"], m.double()).long(), 3)
        # U = T + m p is a multiple of R, so its low limbs (each now in
        # [0, 2^16]) hold 0 or exactly R: carry 1 unless all are zero.
        hi = U[NLIMB:]
        hi[0] += (U[:NLIMB] != 0).any(0)
        return self._cond_sub(_norm(hi, 1).reshape((NLIMB,) + rest))

    # ------------------------------------------------------------ public ops

    @staticmethod
    def _lm(*xs):
        xs = torch.broadcast_tensors(*xs)
        return [x.movedim(-1, 0) for x in xs]

    def add(self, a, b):
        """Modular addition (either domain)."""
        return self.lm_add(*self._lm(a, b)).movedim(0, -1)

    def sub(self, a, b):
        return self.lm_sub(*self._lm(a, b)).movedim(0, -1)

    def neg(self, a):
        """p - a, with -0 = 0."""
        return self.lm_neg(a.movedim(-1, 0)).movedim(0, -1)

    def mont_mul(self, a, b):
        """a * b * R^-1 mod p."""
        return self.lm_mul(*self._lm(a, b)).movedim(0, -1)

    def mont_sqr(self, a):
        return self.mont_mul(a, a)

    def mont_pow(self, a, e: int):
        """a^e in the Montgomery domain (square-and-multiply, MSB first)."""
        acc = self.ones_mont(a.shape[:-1], a.device)
        for bit in bin(e)[2:] if e else "":
            acc = self.mont_mul(acc, acc)
            if bit == "1":
                acc = self.mont_mul(acc, a)
        return acc.contiguous()

    def inv(self, a):
        """a^(p-2): Montgomery in, Montgomery out."""
        return self.mont_pow(a, self.modulus - 2)

    def select(self, cond, a, b):
        return torch.where(cond[..., None], a, b)

    def eq(self, a, b):
        return (a == b).all(-1)

    def is_zero(self, a):
        return (a == 0).all(-1)


FR = FieldCtx(bn254.FR_MOD, name="Fr")
FP = FieldCtx(bn254.FP_MOD, name="Fp")
