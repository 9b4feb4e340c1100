"""Parsers for gnark/sunspot artifact byte formats (.vk / .proof / .pw).

The port's copy of ``tpu_zkpool/groth16/gnark_fmt.py`` (host code, over the
port's ``refimpl/pairing_ref``).

Layouts reverse-engineered from the committed artifacts
(``noir_circuit/target/shielded_pool_verifier.vk``,
``audit_circuit/target/*.vk``). All curve coordinates are 32-byte
big-endian; G2 (Fp2) coordinates are serialized imaginary-part-first
(a1 | a0).

Every point read is checked, and a bad one raises ``ValueError`` (never an
``assert``, which ``python -O`` strips): each coordinate must be below p, a
G1 point on y^2 = x^3 + 3 (the whole curve is the order-r group), a G2
point on the twist and in its order-r subgroup (r Q = O). All zeros is the
identity. A public witness blob must declare no secret values and as many
public values as its vector holds. Departures from the JAX copy, which
asserts on-curve only and reads no count.

VerifyingKey (uncompressed gnark `WriteTo`):
  [0]    Alpha  G1   (64)
  [64]   Beta   G1   (64)       (unused in verification)
  [128]  Beta   G2   (128)
  [256]  Gamma  G2   (128)
  [384]  Delta  G1   (64)       (unused in verification)
  [448]  Delta  G2   (128)
  [576]  u32 BE nbK, then K: nbK x G1 (gamma_abc; includes the extra
         public input added by gnark's Pedersen commitment scheme)
  ...    u32 BE nbCommitments, per-commitment committed-wire index lists,
         then the Pedersen commitment key: G G2 (128), GSigmaNeg G2 (128)

Proof (388 bytes, ``withdraw.rs:13``):
  Ar G1 (64) | Bs G2 (128) | Krs G1 (64) | u32 BE nbCommitments = 1 |
  Commitment G1 (64) | CommitmentPok G1 (64)

Public witness blob (``withdraw.rs:14-16``): 12-byte header
(u32 BE nbPublic, u32 BE nbSecret, u32 BE vectorLen) + 32 bytes per value.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from tpu_zkpool_torch.fields.bn254 import FP_MOD
from tpu_zkpool_torch.refimpl import pairing_ref as pr


def _coords(b: bytes, off: int, n: int) -> list:
    """n 32-byte big-endian coordinates at ``off``, each checked < p."""
    if len(b) < off + 32 * n:
        raise ValueError(f"a point at {off} runs past the end ({len(b)} B)")
    vals = [int.from_bytes(b[off + 32 * i: off + 32 * i + 32], "big")
            for i in range(n)]
    if max(vals) >= FP_MOD:
        raise ValueError(f"a coordinate at {off} is not below p")
    return vals


def _g1(b: bytes, off: int):
    x, y = _coords(b, off, 2)
    if x == 0 and y == 0:
        return None
    if (y * y - (x**3 + 3)) % FP_MOD:
        raise ValueError(f"not on G1 at {off}")
    return (x, y)


def _g2(b: bytes, off: int):
    a1, a0, b1, b0 = _coords(b, off, 4)
    q = ((a0, a1), (b0, b1))
    if q == ((0, 0), (0, 0)):
        return None
    if not pr.g2_is_on_curve(q):
        raise ValueError(f"not on G2 at {off}")
    if pr.g2_mul(pr.R_ORDER, q) is not None:
        raise ValueError(f"not in G2's order-r subgroup at {off}")
    return q


@dataclass
class GnarkVK:
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    gamma_abc: list
    commitment_keys: list          # [(G g2, GSigmaNeg g2)]
    public_committed: list         # per-commitment committed public indices


def parse_vk(raw: bytes) -> GnarkVK:
    alpha = _g1(raw, 0)
    beta1 = _g1(raw, 64)
    beta2 = _g2(raw, 128)
    gamma2 = _g2(raw, 256)
    delta1 = _g1(raw, 384)
    delta2 = _g2(raw, 448)
    (nbk,) = struct.unpack(">I", raw[576:580])
    off = 580
    K = []
    for _ in range(nbk):
        K.append(_g1(raw, off))
        off += 64
    (nbc,) = struct.unpack(">I", raw[off : off + 4])
    off += 4
    committed = []
    for _ in range(nbc):
        (m,) = struct.unpack(">I", raw[off : off + 4])
        off += 4
        idxs = list(struct.unpack(f">{m}I", raw[off : off + 4 * m]))
        off += 4 * m
        committed.append(idxs)
    (nbkeys,) = struct.unpack(">I", raw[off : off + 4])
    off += 4
    keys = []
    for _ in range(nbkeys):
        g = _g2(raw, off)
        gs = _g2(raw, off + 128)
        keys.append((g, gs))
        off += 256
    if off != len(raw):
        raise ValueError(f"vk trailing bytes: {len(raw) - off}")
    return GnarkVK(alpha, beta1, beta2, gamma2, delta1, delta2, K, keys, committed)


@dataclass
class GnarkProof:
    ar: tuple
    bs: tuple
    krs: tuple
    commitments: list
    pok: tuple | None


def parse_proof(raw: bytes) -> GnarkProof:
    ar = _g1(raw, 0)
    bs = _g2(raw, 64)
    krs = _g1(raw, 192)
    (nbc,) = struct.unpack(">I", raw[256:260])
    off = 260
    commitments = []
    for _ in range(nbc):
        commitments.append(_g1(raw, off))
        off += 64
    pok = _g1(raw, off) if len(raw) - off >= 64 else None
    return GnarkProof(ar, bs, krs, commitments, pok)


def parse_public_witness(raw: bytes) -> list:
    """The public values of a witness blob; raises ``ValueError`` unless it
    declares no secret values, ``nb_pub`` equals its vector's length and
    the bytes hold that vector."""
    nb_pub, nb_sec, vec_len = struct.unpack(">III", raw[:12])
    if nb_sec != 0 or nb_pub != vec_len:
        raise ValueError(f"public witness header ({nb_pub}, {nb_sec}, "
                         f"{vec_len}): want (n, 0, n)")
    if len(raw) != 12 + 32 * vec_len:
        raise ValueError(f"public witness of {vec_len} values in "
                         f"{len(raw)} B")
    vals = []
    for i in range(vec_len):
        vals.append(int.from_bytes(raw[12 + 32 * i : 44 + 32 * i], "big"))
    return vals


def emit_proof(ar, bs, krs, commitments=(), pok=None) -> bytes:
    """Serialize a proof in the gnark 388-byte-compatible layout."""
    def g1b(p):
        if p is None:
            return b"\x00" * 64
        return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")

    def g2b(q):
        if q is None:
            return b"\x00" * 128
        (a0, a1), (b0, b1) = q
        return (a1.to_bytes(32, "big") + a0.to_bytes(32, "big")
                + b1.to_bytes(32, "big") + b0.to_bytes(32, "big"))

    out = g1b(ar) + g2b(bs) + g1b(krs) + struct.pack(">I", len(commitments))
    for cpt in commitments:
        out += g1b(cpt)
    if pok is not None or commitments:
        out += g1b(pok)
    return out
