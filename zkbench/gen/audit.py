"""The deposits a compliance service proves audit records for: auditor
keys (``rlwe.keygen``, each from its own seed), depositors (a 128-bit
secret key and its owner point on the embedded curve), each deposit's RLWE
encryption of the owner under its key, its ``wa_commitment`` (circom
Poseidon of the owner) and ``ct_commitment`` (the Poseidon2 sponge over
the packed ciphertext). All of it is drawn from ``--seed`` with the
benchmark's own frozen copies (``zkbench.ref``); deposit i is under key
``i % keys``, so each key has deposits and a rotation is served."""

from __future__ import annotations

import random

from zkbench.ref import curve, rlwe
from zkbench.ref.audit_circuit import ct_commitment_of
from zkbench.ref.poseidon_params import poseidon_hash_ref as H


def make(cfg: dict, traffic: dict, seed: int, cache_dir: str) -> list:
    """``traffic["distinct"]`` deposits, each a dict with ``key`` (the
    auditor key's (a, b)), ``sk``, ``owner_x``, ``owner_y``, ``enc`` (the
    encryption record), ``wa`` and ``ct``."""
    rng = random.Random(seed)
    keys = []
    for _ in range(cfg["auditor_keys"]):
        k = rlwe.keygen(rng.getrandbits(63))
        keys.append((k["a"], k["b"]))
    out = []
    for i in range(int(traffic["distinct"])):
        a, b = keys[i % len(keys)]
        sk = rng.getrandbits(128)
        ox, oy = curve.scalar_mul(sk)
        enc = rlwe.encrypt(a, b, ox, oy, seed=rng.getrandbits(63))
        out.append({"key": (a, b), "sk": sk, "owner_x": ox, "owner_y": oy,
                    "enc": enc, "wa": H([ox, oy]),
                    "ct": ct_commitment_of(enc)})
    return out
