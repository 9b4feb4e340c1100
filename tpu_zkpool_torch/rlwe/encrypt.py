"""RLWE (BFV-style) keygen / encrypt / decrypt in torch, bit-exact.

The port of ``tpu_zkpool/rlwe/encrypt.py``. The semantics are the
reference's (``rlwe_ref.keygen``, ``encrypt``, ``decrypt``):

  b = -(a*sk) + e            (keygen, negacyclic mod q)
  c0 = (b*r + e1 + Delta*msg) mod q   (first MSG_SLOTS coefficients kept)
  c1 = (a*r + e2) mod q
  dec: msg[i] = round(centered(c0[i] + (sk*c1)[i]) / Delta) mod t

Polynomials are int32 tensors of values in [0, q) (``fields/rlweq.py``),
batched over leading axes; the negacyclic products run through the port's
NTT (``rlwe/ntt.py``) on the tensors' device. The seeded noise stays on the
host (``rlwe_ref``'s ``random.Random`` draw order).

:func:`centered_mod_q` maps Fr values (a Shamir reconstruction's output) to
the ring as the auditor's decrypt does, ``centered_mod(v, r) % q``, on the
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.fields.limbs import NLIMB, WBITS, int_to_limbs
from tpu_zkpool_torch.fields.rlweq import Q
from tpu_zkpool_torch.refimpl.rlwe_ref import (
    DELTA, MSG_SLOTS, PLAINTEXT_MOD, encode_field_to_bytes,
)
from tpu_zkpool_torch.rlwe import ntt


def keygen_from_randomness(sk_mod_q, a, e_mod_q):
    """b = -(a*sk) + e mod q. All int32[..., N] tensors < q."""
    a_sk = ntt.negacyclic_mul(a, sk_mod_q)
    return torch.remainder(Q - a_sk + e_mod_q, Q)


def encrypt_core(pk_a, pk_b, r_mod_q, e1_mod_q, e2_mod_q, delta_msg):
    """(c0_sparse, c1) from mod-q inputs.

    pk_a/pk_b: int32[N]; r/e2: int32[..., N]; e1/delta_msg:
    int32[..., MSG_SLOTS]. Returns c0 int32[..., MSG_SLOTS], c1 [..., N].
    """
    br = ntt.negacyclic_mul(pk_b, r_mod_q)
    c0 = torch.remainder(br[..., :MSG_SLOTS] + e1_mod_q + delta_msg, Q)
    ar = ntt.negacyclic_mul(pk_a, r_mod_q)
    c1 = torch.remainder(ar + e2_mod_q, Q)
    return c0, c1


def decrypt_core(sk_mod_q, c0_sparse, c1):
    """Noisy plaintext slots: round(centered(c0 + sk*c1)/Delta) mod t, the
    rounding half to even at exact halves (Python's ``round``)."""
    sk_c1 = ntt.negacyclic_mul(sk_mod_q, c1)
    noisy = torch.remainder(c0_sparse + sk_c1[..., :MSG_SLOTS], Q)
    # centered value in (-q/2, q/2]; q < 2^28, so 2 x + Delta fits int32
    centered = noisy - torch.where(noisy > Q // 2, Q, 0).to(noisy.dtype)
    num = 2 * centered + DELTA
    q2 = torch.div(num, 2 * DELTA, rounding_mode="floor")
    tie = torch.remainder(num, 2 * DELTA) == 0
    rounded = torch.where(tie & (torch.remainder(q2, 2) == 1), q2 - 1, q2)
    return torch.remainder(rounded, PLAINTEXT_MOD).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _fr_consts(device: torch.device):
    """(limbs of 1, limbs of (r - 1) / 2, 2^(16 i) mod q, sign weights
    2^i) on ``device``."""
    t = functools.partial(torch.as_tensor, dtype=torch.int64, device=device)
    return (t(int_to_limbs(1)), t(int_to_limbs((FR.modulus - 1) // 2)),
            t([pow(2, WBITS * i, Q) for i in range(NLIMB)]),
            t([1 << i for i in range(NLIMB)]))


def centered_mod_q(x: torch.Tensor) -> torch.Tensor:
    """int64[..., 16] Montgomery Fr limbs -> int32[...] values
    ``centered_mod(v, r) % q`` (``rlwe_ref``): v itself mod q if v <= (r -
    1)/2, else (v - r) mod q. On x's device, no host read."""
    one, half, pow_q, weight = _fr_consts(x.device)
    v = FR.mont_mul(x, one)                       # plain limbs
    vq = torch.remainder((v * pow_q).sum(-1), Q)  # < 16 * 2^44
    # v > half: the highest limb that differs decides (2^i > sum of 2^j < i)
    above = (torch.sign(v - half) * weight).sum(-1) > 0
    return torch.remainder(vq - above * (FR.modulus % Q), Q).to(torch.int32)


# --------------------------------------------------------------- host API

def encode_message(owner_x: int, owner_y: int) -> np.ndarray:
    return np.asarray(
        encode_field_to_bytes(owner_x) + encode_field_to_bytes(owner_y),
        dtype=np.uint32,
    )


def signed_to_mod_q(vals) -> np.ndarray:
    return np.asarray([v % Q for v in vals], dtype=np.uint32)


def decode_message(msg_slots) -> tuple:
    if isinstance(msg_slots, torch.Tensor):
        msg_slots = msg_slots.cpu().numpy()
    msg = [int(v) for v in np.asarray(msg_slots)]
    x = sum((msg[i] & 0xFF) << (8 * i) for i in range(32))
    y = sum((msg[32 + i] & 0xFF) << (8 * i) for i in range(32))
    return x, y
