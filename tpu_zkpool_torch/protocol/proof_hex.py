"""Proof/witness hex bundling + address-table compression (C20).

The port's copy of ``tpu_zkpool/protocol/proof_hex.py`` (host code).

Our equivalent of ``client/generate-proof-hex.ts:29-120`` (dump the
388-byte proof and public-witness blobs as hex for relayer submission)
and ``client/create-alt.ts:26-95`` (a lookup table of the pool's static
account addresses so relayed payloads reference 1-byte indices instead of
32-byte keys — Solana's ALT, reframed for our relayer transport).
"""

from __future__ import annotations

import json

from tpu_zkpool_torch.groth16.gnark_fmt import emit_proof
from tpu_zkpool_torch.protocol.errors import ErrorCode, ShieldedPoolError


def proof_to_hex(proof: tuple) -> str:
    """(A, B2, C[, Commitment, Pok]) affine tuple -> gnark 388-byte hex."""
    if len(proof) == 5:
        a, b2, c, cm, pok = proof
        raw = emit_proof(a, b2, c, [cm], pok)
    else:
        a, b2, c = proof
        raw = emit_proof(a, b2, c)
    return raw.hex()


def bundle(withdraw_proof: tuple, withdraw_witness_blob: bytes,
           audit_proof: tuple | None = None,
           audit_witness_blob: bytes | None = None) -> dict:
    """The generate-proof-hex.ts output payload: hex strings ready to
    paste into the relayer/demo flows."""
    out = {
        "withdraw": {
            "proof_hex": proof_to_hex(withdraw_proof),
            "witness_hex": withdraw_witness_blob.hex(),
        }
    }
    if audit_proof is not None:
        out["audit"] = {
            "proof_hex": proof_to_hex(audit_proof),
            "witness_hex": (audit_witness_blob or b"").hex(),
        }
    return out


def save_bundle(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def load_bundle(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    for leg in data.values():
        try:
            bytes.fromhex(leg["proof_hex"])
            bytes.fromhex(leg["witness_hex"])
        except (KeyError, ValueError) as e:
            raise ShieldedPoolError(ErrorCode.PROOF_PARSE_ERROR, str(e), e)
    return data


class AddressTable:
    """Static-address lookup table (create-alt.ts): the 8 pool accounts a
    relayed withdraw references, compressed to 1-byte indices."""

    STATIC_KEYS = ("pool_state", "vault", "pool_program",
                   "withdraw_verifier", "audit_verifier", "system_program",
                   "relayer", "recipient_slot")

    def __init__(self, addresses: dict):
        missing = set(self.STATIC_KEYS) - set(addresses)
        assert not missing, f"missing addresses: {missing}"
        self._fwd = {k: i for i, k in enumerate(self.STATIC_KEYS)}
        self._addr = [addresses[k] for k in self.STATIC_KEYS]

    def index_of(self, name: str) -> int:
        return self._fwd[name]

    def address(self, idx: int):
        return self._addr[idx]

    def compress(self, names: list) -> bytes:
        return bytes(self._fwd[n] for n in names)

    def expand(self, idxs: bytes) -> list:
        return [self._addr[i] for i in idxs]
