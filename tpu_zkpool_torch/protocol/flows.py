"""Client-side flows: deposit, withdraw witness assembly, audit.

The port's copy of ``tpu_zkpool/protocol/flows.py``: the same blobs byte for
byte; ``build_withdraw_witness`` reads the sibling path from the port's
``MerkleTree`` (levels built on its device, kernel K7 on a CUDA tree).

The typed-struct equivalents of the reference's Prover.toml generation and
instruction building (``client/proof.helper.ts:30-52``,
``demo-frontend/app/lib/rlwe.ts:250-293``, ``shielded-pool-card.tsx:304-308``).
"""

from __future__ import annotations

import secrets
import struct
from dataclasses import dataclass, field

from tpu_zkpool_torch.fields.bn254 import FR_MOD
from tpu_zkpool_torch.hash.poseidon_params import poseidon_hash_ref as H
from tpu_zkpool_torch.merkle import MerkleTree
from tpu_zkpool_torch.protocol import state as st
from tpu_zkpool_torch.refimpl import curve_ref

DEPOSIT_IX = 1   # instructions/mod.rs discriminators: 0 init, 1 deposit,
WITHDRAW_IX = 2  # 2 withdraw, 3 submit_audit
SUBMIT_AUDIT_IX = 3


@dataclass
class Identity:
    """BabyJubJub-style identity (client/merkle.ts:98-113): sk <= 128 bits."""

    secret_key: int
    owner_x: int
    owner_y: int

    @classmethod
    def generate(cls, secret_key: int | None = None) -> "Identity":
        sk = (secret_key if secret_key is not None
              else secrets.randbits(128)) % (1 << 128)
        pt = curve_ref.scalar_mul(sk)
        return cls(sk, pt[0], pt[1])

    @property
    def wa_commitment(self) -> int:
        return H([self.owner_x, self.owner_y])


@dataclass
class Note:
    identity: Identity
    amount: int
    randomness: int = field(default_factory=lambda: secrets.randbits(200))

    @property
    def commitment(self) -> int:
        return H([self.identity.owner_x, self.identity.owner_y,
                  self.amount, self.randomness])

    def nullifier(self, leaf_index: int) -> int:
        return H([self.identity.secret_key, leaf_index])


@dataclass
class WithdrawWitness:
    """The withdraw circuit's full assignment (client/prover-params.toml)."""

    root: int
    nullifier: int
    recipient_field: int
    amount: int
    wa_commitment: int
    secret_key: int
    owner_x: int
    owner_y: int
    randomness: int
    index: int
    siblings: list

    def public_inputs(self) -> list:
        return [self.root, self.nullifier, self.recipient_field,
                self.amount, self.wa_commitment]

    def acir_inputs(self) -> dict:
        vals = self.public_inputs() + [
            self.secret_key, self.owner_x, self.owner_y, self.randomness,
            self.index,
        ] + list(self.siblings)
        return {i: v for i, v in enumerate(vals)}

    def witness_blob(self) -> bytes:
        """12-byte header + 5 x 32 BE values (withdraw.rs:70-90)."""
        out = struct.pack(">III", 5, 0, 5)
        for v in self.public_inputs():
            out += (v % FR_MOD).to_bytes(32, "big")
        return out


def deposit_instruction(amount: int, commitment: int, new_root: int) -> bytes:
    """[DEPOSIT, amount u64 LE, commitment 32, new_root 32] (deposit.rs:23-25,
    shielded-pool-card.tsx:304-308)."""
    return (bytes([DEPOSIT_IX]) + struct.pack("<Q", amount)
            + commitment.to_bytes(32, "little") + new_root.to_bytes(32, "little"))


def build_withdraw_witness(tree: MerkleTree, note: Note, leaf_index: int,
                           recipient_pubkey: bytes, amount: int) -> WithdrawWitness:
    rec_field = int.from_bytes(st.encode_recipient(recipient_pubkey), "big")
    return WithdrawWitness(
        root=tree.get_root(),
        nullifier=note.nullifier(leaf_index),
        recipient_field=rec_field,
        amount=amount,
        wa_commitment=note.identity.wa_commitment,
        secret_key=note.identity.secret_key,
        owner_x=note.identity.owner_x,
        owner_y=note.identity.owner_y,
        randomness=note.randomness,
        index=leaf_index,
        siblings=tree.get_proof(leaf_index),
    )


def audit_witness_blob(wa_commitment: int, ct_commitment: int) -> bytes:
    """12-byte header + 2 x 32 BE (submit_audit.rs:49-54)."""
    out = struct.pack(">III", 2, 0, 2)
    out += (wa_commitment % FR_MOD).to_bytes(32, "big")
    out += (ct_commitment % FR_MOD).to_bytes(32, "big")
    return out
