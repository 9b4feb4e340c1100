"""Pool state machine with the reference's on-chain byte layouts.

The port's copy of ``tpu_zkpool/protocol/state.py`` (host code).

Mirrors ``shielded_pool_program/src/state.rs`` exactly:

- ``ShieldedPoolState``: 1072 bytes = discriminator b"poolstat" (8) +
  current_root (32) + root_history (32 x 32) + roots_index u64 LE (8);
  ``add_root`` pushes into the ring buffer, ``check_root`` scans the
  32-entry window (``state.rs:28-46``).
- ``AuditRecord``: 40 bytes = b"auditrec" + wa_commitment (32)
  (``state.rs:52-66``).

The instruction-level semantics (lamport moves, PDA existence checks,
idempotency) follow ``instructions/{initialize,deposit,withdraw,
submit_audit}.rs`` and are exercised by the flow tests, including the
reference's negative cases (double spend, wrong recipient, bad proof).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

POOL_DISCRIMINATOR = b"poolstat"
AUDIT_DISCRIMINATOR = b"auditrec"
ROOT_HISTORY = 32
MIN_RENT_EXEMPT = 890_880            # payroll-demo.ts:89-92
PROOF_LEN = 388                      # withdraw.rs:13
WITHDRAW_WITNESS_LEN = 12 + 5 * 32   # withdraw.rs:14-16
AUDIT_WITNESS_LEN = 12 + 2 * 32      # submit_audit.rs:19-21


class PoolError(Exception):
    pass


@dataclass
class ShieldedPoolState:
    current_root: int = 0
    root_history: list = field(default_factory=lambda: [0] * ROOT_HISTORY)
    roots_index: int = 0

    def add_root(self, root: int) -> None:
        """state.rs:28-33 — write then advance the ring index."""
        self.current_root = root
        self.root_history[self.roots_index % ROOT_HISTORY] = root
        self.roots_index = (self.roots_index + 1) % ROOT_HISTORY

    def check_root(self, root: int) -> bool:
        """state.rs:36-46 — any match in the 32-root window (0 invalid)."""
        if root == 0:
            return False
        return root in self.root_history

    def root_age(self, root: int) -> int | None:
        """Slots since insertion (newest = 0), per on-chain.ts:202-219."""
        if root not in self.root_history:
            return None
        pos = self.root_history.index(root)
        newest = (self.roots_index - 1) % ROOT_HISTORY
        return (newest - pos) % ROOT_HISTORY

    # ------------------------------------------------------------ bytes

    def to_bytes(self) -> bytes:
        out = POOL_DISCRIMINATOR + self.current_root.to_bytes(32, "little")
        for r in self.root_history:
            out += r.to_bytes(32, "little")
        out += struct.pack("<Q", self.roots_index)
        assert len(out) == 1072
        return out

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ShieldedPoolState":
        assert len(raw) == 1072 and raw[:8] == POOL_DISCRIMINATOR
        cur = int.from_bytes(raw[8:40], "little")
        hist = [
            int.from_bytes(raw[40 + 32 * i : 72 + 32 * i], "little")
            for i in range(ROOT_HISTORY)
        ]
        (idx,) = struct.unpack("<Q", raw[1064:1072])
        return cls(cur, hist, idx)


@dataclass
class AuditRecord:
    wa_commitment: int

    def to_bytes(self) -> bytes:
        return AUDIT_DISCRIMINATOR + self.wa_commitment.to_bytes(32, "little")

    @classmethod
    def from_bytes(cls, raw: bytes) -> "AuditRecord":
        assert len(raw) == 40 and raw[:8] == AUDIT_DISCRIMINATOR
        return cls(int.from_bytes(raw[8:40], "little"))


# ------------------------------------------------------- recipient/amount

def encode_recipient(pubkey32: bytes) -> bytes:
    """32-byte field = [0, 0] ++ pubkey[0..30] (withdraw.rs:149-154)."""
    assert len(pubkey32) == 32
    return b"\x00\x00" + pubkey32[:30]


def encode_amount(amount: int) -> bytes:
    """u64 BE in the last 8 bytes of a 32-byte field (withdraw.rs:156-161)."""
    return b"\x00" * 24 + struct.pack(">Q", amount)


@dataclass
class Pool:
    """Full pool machine: state PDA + vault + nullifier/audit PDAs.

    ``verifier`` callbacks take (proof_bytes, witness_bytes) and return
    bool — the CPI into the Groth16 verifier program
    (withdraw.rs:163-175, submit_audit.rs:81-87).
    """

    withdraw_verifier: object
    audit_verifier: object
    state: ShieldedPoolState = field(default_factory=ShieldedPoolState)
    vault_lamports: int = MIN_RENT_EXEMPT
    nullifiers: set = field(default_factory=set)
    audit_records: dict = field(default_factory=dict)
    initialized: bool = False

    def initialize(self) -> None:
        """Idempotent (initialize.rs:60-63)."""
        if not self.initialized:
            self.state = ShieldedPoolState()
            self.initialized = True

    def deposit(self, payer_balance: int, amount: int, commitment: int,
                new_root: int) -> int:
        """deposit.rs:8-77 — transfers lamports, pushes client root.
        Returns the payer's new balance."""
        if amount <= 0 or payer_balance < amount:
            raise PoolError("insufficient funds")
        self.vault_lamports += amount
        self.state.add_root(new_root)
        return payer_balance - amount

    def submit_audit(self, proof: bytes, witness: bytes) -> int:
        """submit_audit.rs:23-121. Returns the wa commitment. Idempotent."""
        if len(proof) != PROOF_LEN or len(witness) != AUDIT_WITNESS_LEN:
            raise PoolError("bad audit payload size")
        wa = int.from_bytes(witness[12:44], "big")
        if wa in self.audit_records:
            return wa  # idempotent (submit_audit.rs:65-78)
        if not self.audit_verifier(proof, witness):
            raise PoolError("audit proof verification failed")
        self.audit_records[wa] = AuditRecord(wa)
        return wa

    def withdraw(self, proof: bytes, witness: bytes) -> tuple:
        """withdraw.rs:22-228. Returns (recipient_bytes, amount)."""
        if len(proof) != PROOF_LEN or len(witness) != WITHDRAW_WITNESS_LEN:
            raise PoolError("bad withdraw payload size")
        root = int.from_bytes(witness[12:44], "big")
        nullifier = int.from_bytes(witness[44:76], "big")
        recipient = witness[76:108]
        amount_field = witness[108:140]
        wa = int.from_bytes(witness[140:172], "big")

        if wa not in self.audit_records:        # withdraw.rs:92-127
            raise PoolError("audit record missing")
        if not self.state.check_root(root):     # withdraw.rs:131-134
            raise PoolError("unknown root")
        if nullifier in self.nullifiers:        # withdraw.rs:137-147
            raise PoolError("nullifier already used")
        if recipient[:2] != b"\x00\x00":        # withdraw.rs:149-154
            raise PoolError("bad recipient encoding")
        amount = struct.unpack(">Q", amount_field[24:])[0]
        if not self.withdraw_verifier(proof, witness):
            raise PoolError("proof verification failed")
        if self.vault_lamports - amount < MIN_RENT_EXEMPT:
            raise PoolError("vault would drop below rent exemption")
        self.nullifiers.add(nullifier)          # the mutual exclusion
        self.vault_lamports -= amount
        return recipient, amount
