"""gnark-style Pedersen vector commitments over BN254 G1 (host code).

A copy of ``tpu_zkpool.refimpl.pedersen`` for the PyTorch port, which
imports nothing of the JAX package. Committed verifier programs check
proofs whose VK carries a Pedersen commitment key and whose 388-byte proof
carries Commitment + CommitmentPok. This module
implements the scheme the way gnark-crypto's ``pedersen`` package does:

- proving key: basis points B_i (in Groth16 these are the committed wires'
  [(beta u_i + alpha v_i + w_i)/gamma]_1 points) and sigma * B_i,
- commitment C = sum w_i B_i, proof-of-knowledge pok = sigma * C,
- verification e(C, -sigma G2) * e(pok, G2) == 1,
- the commitment binds into the Groth16 public-input (gamma) leg, and its
  hash-to-field becomes an extra public input the verifier derives itself.

The hash-to-field is RFC 9380 expand_message_xmd(SHA-256) reduced mod r,
as in gnark-crypto ``fr.Hash`` (48 expanded bytes per element, OS2IP mod r).
"""

from __future__ import annotations

import hashlib

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.refimpl import pairing_ref as pr

# Domain-separation tag for the commitment hash-to-field, pinned from
# gnark's public source: the constant
# ``CommitmentDst = "bsb22-commitment"`` in gnark's ``constraint`` package
# is what both prover and verifier pass to gnark-crypto's
# ``hash_to_field.New([]byte(constraint.CommitmentDst))`` in
# ``backend/groth16/bn254/{prove,verify}.go`` (gnark v0.9+, the line of
# releases sunspot builds on). The hashed message is gnark's
# ``constraint.SerializeCommitment``: the 64-byte uncompressed G1 marshal
# of the commitment followed by any committed PUBLIC wire values as
# 32-byte BE — Noir/sunspot circuits commit only private wires, so the
# message is exactly ``g1_marshal(cm)``. The reference repo commits no
# ``.proof`` artifact to cross-check bytes against, so this pin is from
# gnark source, not a committed vector.
COMMITMENT_DST = b"bsb22-commitment"


def expand_message_xmd(msg: bytes, dst: bytes, out_len: int) -> bytes:
    """RFC 9380 expand_message_xmd with SHA-256."""
    b_in_bytes = 32
    ell = -(-out_len // b_in_bytes)
    assert ell <= 255 and len(dst) <= 255
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(64)  # SHA-256 block size
    l_i_b = out_len.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    for i in range(2, ell + 1):
        xored = bytes(a ^ b for a, b in zip(b0, out[-1]))
        out.append(hashlib.sha256(xored + bytes([i]) + dst_prime).digest())
    return b"".join(out)[:out_len]


def hash_to_field(msg: bytes, dst: bytes = COMMITMENT_DST) -> int:
    """One Fr element via expand_message_xmd (48 bytes -> mod r)."""
    return int.from_bytes(expand_message_xmd(msg, dst, 48), "big") % R


def g1_marshal(p) -> bytes:
    """gnark uncompressed G1 marshal: 32-byte BE x || y (zeroes for inf)."""
    if p is None:
        return bytes(64)
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def commitment_to_field(cm) -> int:
    """The extra public input a commitment contributes (verifier-derived)."""
    return hash_to_field(g1_marshal(cm))


def commit(basis: list, basis_exp_sigma: list, values: list):
    """(C, pok) for committed wire values (ints mod r)."""
    assert len(basis) == len(values) == len(basis_exp_sigma)
    C = None
    pok = None
    for b, bs, v in zip(basis, basis_exp_sigma, values):
        v = v % R
        if not v:
            continue
        C = pr.g1_add(C, pr.g1_mul(v, b))
        pok = pr.g1_add(pok, pr.g1_mul(v, bs))
    return C, pok


def verify_pok(cm, pok, key) -> bool:
    """key = (G g2, GSigmaNeg g2): e(C, GSigmaNeg) * e(pok, G) == 1."""
    g, g_sigma_neg = key
    if cm is None:
        return pok is None
    e1 = pr.pairing(cm, g_sigma_neg)
    e2 = pr.pairing(pok, g) if pok is not None else pr.F12_ONE
    return pr.f12_mul(e1, e2) == pr.F12_ONE
