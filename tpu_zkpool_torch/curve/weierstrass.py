"""Batched Jacobian point arithmetic for a = 0 short-Weierstrass curves.

The port of ``tpu_zkpool/curve/weierstrass.py``. Points are (X, Y, Z) limb
triples, ``int64[..., 16]`` each, Montgomery domain, with Z = 0 encoding the
identity. Complete addition is the standard Jacobian formulas plus lane-wise
selects for the special cases, so one call processes an arbitrary batch: the
building block of batched identity keygen (replacing noble-curves at
``client/merkle.ts:104``).

Every op is a fixed sequence of ``FieldCtx`` tensor ops on the operands'
device; the JAX module's ``lax.scan`` over the scalar bits is a Python loop
here. The JAX package has no Pallas kernel for these ops, so neither does
the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.fields import bn254
from tpu_zkpool_torch.fields.fctx import FP, FR, FieldCtx
from tpu_zkpool_torch.fields.limbs import NLIMB


@dataclass(frozen=True, eq=False)
class CurveOps:
    """Batched ops on y^2 = x^3 + b over field F (a = 0)."""

    F: FieldCtx
    b: int
    gen: tuple  # (gx, gy) Python ints
    order: int

    # ------------------------------------------------------------- helpers

    def identity(self, shape=(), device=None):
        """The identity (all limbs zero) of batch ``shape`` on ``device``
        (``cuda`` unless the caller names another)."""
        z = torch.zeros(tuple(shape) + (NLIMB,), dtype=torch.int64,
                        device=resolve_device(device))
        return z, z, z

    def from_affine_ints(self, xs, ys, device=None):
        """Host ints -> Jacobian (Z = 1) Montgomery limbs on ``device``
        (``cuda`` unless the caller names another)."""
        dev = resolve_device(device)
        X = torch.as_tensor(self.F.to_mont(np.asarray(xs, dtype=object)),
                            device=dev)
        Y = torch.as_tensor(self.F.to_mont(np.asarray(ys, dtype=object)),
                            device=dev)
        Z = self.F.ones_mont(X.shape[:-1], dev).contiguous()
        return X, Y, Z

    def to_affine_ints(self, P):
        """Jacobian limbs -> host object arrays (x, y), the identity as
        (0, 0)."""
        X, Y, Z = P
        F = self.F
        inf = F.is_zero(Z)
        zinv = F.inv(torch.where(inf[..., None],
                                 F.ones_mont(Z.shape[:-1], Z.device), Z))
        zinv2 = F.mont_mul(zinv, zinv)
        x = F.mont_mul(X, zinv2)
        y = F.mont_mul(Y, F.mont_mul(zinv2, zinv))
        x = torch.where(inf[..., None], torch.zeros_like(x), x)
        y = torch.where(inf[..., None], torch.zeros_like(y), y)
        return F.from_mont(x), F.from_mont(y)

    # ----------------------------------------------------------- arithmetic

    def double(self, P):
        """2P, Jacobian a=0: handles Z=0 and Y=0 via the formulas (Z3=2YZ=0)."""
        F = self.F
        X, Y, Z = P
        A = F.mont_mul(X, X)
        B = F.mont_mul(Y, Y)
        C = F.mont_mul(B, B)
        xb = F.add(X, B)
        D = F.sub(F.sub(F.mont_mul(xb, xb), A), C)
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        Fq = F.mont_mul(E, E)
        X3 = F.sub(Fq, F.add(D, D))
        C8 = F.add(C, C); C8 = F.add(C8, C8); C8 = F.add(C8, C8)
        Y3 = F.sub(F.mont_mul(E, F.sub(D, X3)), C8)
        YZ = F.mont_mul(Y, Z)
        Z3 = F.add(YZ, YZ)
        return X3, Y3, Z3

    def add(self, P, Q):
        """P + Q, complete (select-based) Jacobian addition. The selects run
        in the JAX module's order (doubling, cancelling to the identity,
        P at infinity, Q at infinity), so every lane's limbs equal its."""
        F = self.F
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        Z1Z1 = F.mont_mul(Z1, Z1)
        Z2Z2 = F.mont_mul(Z2, Z2)
        U1 = F.mont_mul(X1, Z2Z2)
        U2 = F.mont_mul(X2, Z1Z1)
        S1 = F.mont_mul(Y1, F.mont_mul(Z2, Z2Z2))
        S2 = F.mont_mul(Y2, F.mont_mul(Z1, Z1Z1))
        H = F.sub(U2, U1)
        r = F.sub(S2, S1)
        HH = F.mont_mul(H, H)
        HHH = F.mont_mul(H, HH)
        V = F.mont_mul(U1, HH)
        r2 = F.mont_mul(r, r)
        X3 = F.sub(F.sub(r2, HHH), F.add(V, V))
        Y3 = F.sub(F.mont_mul(r, F.sub(V, X3)), F.mont_mul(S1, HHH))
        Z3 = F.mont_mul(F.mont_mul(Z1, Z2), H)

        # special cases
        p_inf = F.is_zero(Z1)
        q_inf = F.is_zero(Z2)
        same_x = F.is_zero(H)
        same_y = F.is_zero(r)
        dbl = self.double(P)
        is_dbl = same_x & same_y & ~p_inf & ~q_inf
        to_inf = same_x & ~same_y & ~p_inf & ~q_inf

        out = []
        for i, v in enumerate((X3, Y3, Z3)):
            v = F.select(is_dbl, dbl[i], v)
            v = F.select(to_inf, torch.zeros_like(v), v)
            v = F.select(p_inf, Q[i], v)
            v = F.select(q_inf, P[i], v)
            out.append(v)
        return tuple(out)

    def scalar_mul(self, bits, P):
        """[k]P with k given as int64[..., NBITS] bits, MSB first, on P's
        device: a Python loop of one doubling, one complete add and one
        select a bit, batched over per-lane scalars and points."""
        dev = P[0].device
        bits = torch.as_tensor(bits, device=dev)
        acc = self.identity(bits.shape[:-1], dev)
        for j in range(bits.shape[-1]):
            acc = self.double(acc)
            added = self.add(acc, P)
            take = bits[..., j] == 1
            acc = tuple(self.F.select(take, a, b) for a, b in zip(added, acc))
        return acc

    @staticmethod
    def bits_from_ints(ks, nbits: int) -> np.ndarray:
        """Host: int scalars -> int64[..., nbits] MSB-first bit arrays (the
        low ``nbits`` bits of each)."""
        ks = np.asarray(ks, dtype=object)
        flat = ks.reshape(-1)
        nbytes = -(-nbits // 8)
        mod = 1 << (8 * nbytes)
        buf = b"".join((int(k) % mod).to_bytes(nbytes, "little")
                       for k in flat.tolist())
        bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8),
                             bitorder="little").reshape(flat.shape[0], -1)
        out = bits[:, :nbits][:, ::-1].astype(np.int64)
        return out.reshape(ks.shape + (nbits,))


EMBEDDED = CurveOps(
    F=FR,
    b=bn254.EMBEDDED_B,
    gen=(bn254.EMBEDDED_GX, bn254.EMBEDDED_GY),
    order=bn254.EMBEDDED_ORDER,
)

G1 = CurveOps(F=FP, b=3, gen=(bn254.G1_GX, bn254.G1_GY), order=bn254.FR_MOD)

# The JAX module's G1_UNROLLED runs the same math over its scan-free field
# form FP_U. The port has one FieldCtx form, so it names the same object.
G1_UNROLLED = G1
