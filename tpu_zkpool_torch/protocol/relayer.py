"""Audit-then-withdraw relayer.

The port's copy of ``tpu_zkpool/protocol/relayer.py`` (host code); it counts
into the port's metrics registry.

Mirrors the reference relayer's two-transaction flow
(``demo-frontend/app/api/relay/withdraw/route.ts:88-309``): extract wa from
the audit witness, submit the audit proof (tolerating an already-existing
record), then submit the withdrawal — plus a health/status endpoint
equivalent (``status/route.ts:38-57``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tpu_zkpool_torch.protocol.state import Pool, PoolError
from tpu_zkpool_torch.utils.metrics import DEFAULT as METRICS

LOW_BALANCE_THRESHOLD = 10_000_000


@dataclass
class RelayResult:
    wa_commitment: int
    recipient: bytes
    amount: int
    audit_was_new: bool


@dataclass
class Relayer:
    pool: Pool
    balance_lamports: int = 1_000_000_000
    log: list = field(default_factory=list)

    def status(self) -> dict:
        """Health endpoint (status/route.ts:38-57)."""
        return {
            "balance": self.balance_lamports,
            "low_balance": self.balance_lamports < LOW_BALANCE_THRESHOLD,
            "metrics": METRICS.snapshot(),
        }

    def relay_withdraw(self, withdraw_proof: bytes, withdraw_witness: bytes,
                       audit_proof: bytes, audit_witness: bytes) -> RelayResult:
        """Tx1 submit_audit (tolerant), then Tx2 withdraw
        (withdraw/route.ts:238-295)."""
        wa = int.from_bytes(audit_witness[12:44], "big")
        audit_new = wa not in self.pool.audit_records
        METRICS.incr("relayer.withdraw_requests")
        try:
            self.pool.submit_audit(audit_proof, audit_witness)
        except PoolError as e:
            # the reference tolerates audit-tx failure only when the record
            # already exists (route.ts:252-268)
            if audit_new:
                raise
            self.log.append(f"audit tx tolerated failure: {e}")
        with METRICS.timer("relayer.withdraw_s"):
            recipient, amount = self.pool.withdraw(withdraw_proof,
                                                   withdraw_witness)
        METRICS.incr("relayer.withdrawals")
        METRICS.incr("relayer.lamports_out", amount)
        self.log.append(f"withdrew {amount} to {recipient.hex()[:16]}")
        return RelayResult(wa, recipient, amount, audit_new)
