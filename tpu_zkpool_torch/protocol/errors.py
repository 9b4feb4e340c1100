"""Typed error codes with user recovery hints + pool-log parsing (C24).

The port's copy of ``tpu_zkpool/protocol/errors.py`` (host code).

Our equivalent of ``demo-frontend/app/lib/errors.ts:116-182``: every
protocol failure maps to a stable code, a human message, and a recovery
hint; ``parse_pool_error`` classifies raw ``PoolError`` messages (the
analogue of parsing Solana transaction logs) and ``status`` builds the
UI-facing status record the relayer/demo surfaces return.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from tpu_zkpool_torch.protocol.state import PoolError


class ErrorCode(str, Enum):
    ROOT_EXPIRED = "ROOT_EXPIRED"
    NULLIFIER_ALREADY_USED = "NULLIFIER_ALREADY_USED"
    PROOF_PARSE_ERROR = "PROOF_PARSE_ERROR"
    WITNESS_PARSE_ERROR = "WITNESS_PARSE_ERROR"
    PROOF_VERIFICATION_FAILED = "PROOF_VERIFICATION_FAILED"
    AUDIT_RECORD_MISSING = "AUDIT_RECORD_MISSING"
    INSUFFICIENT_FUNDS = "INSUFFICIENT_FUNDS"
    INVALID_AMOUNT = "INVALID_AMOUNT"
    INVALID_RECIPIENT = "INVALID_RECIPIENT"
    DEPOSIT_NOT_FOUND = "DEPOSIT_NOT_FOUND"
    STORAGE_ERROR = "STORAGE_ERROR"
    TRANSACTION_FAILED = "TRANSACTION_FAILED"


MESSAGES = {
    ErrorCode.ROOT_EXPIRED:
        "The Merkle root for this deposit has expired",
    ErrorCode.NULLIFIER_ALREADY_USED:
        "This deposit has already been withdrawn",
    ErrorCode.PROOF_PARSE_ERROR: "Failed to parse ZK proof data",
    ErrorCode.WITNESS_PARSE_ERROR: "Failed to parse public witness data",
    ErrorCode.PROOF_VERIFICATION_FAILED: "ZK proof verification failed",
    ErrorCode.AUDIT_RECORD_MISSING:
        "No audit record exists for this deposit's wa commitment",
    ErrorCode.INSUFFICIENT_FUNDS: "Insufficient funds in shielded pool",
    ErrorCode.INVALID_AMOUNT: "Invalid deposit amount",
    ErrorCode.INVALID_RECIPIENT: "Invalid recipient address",
    ErrorCode.DEPOSIT_NOT_FOUND: "Deposit record not found",
    ErrorCode.STORAGE_ERROR: "Failed to access local storage",
    ErrorCode.TRANSACTION_FAILED: "Transaction failed",
}

RECOVERY_HINTS = {
    ErrorCode.ROOT_EXPIRED:
        "Re-sync the tree and regenerate the proof against the current "
        "root (only the most recent 32 roots are accepted)",
    ErrorCode.NULLIFIER_ALREADY_USED:
        "Each deposit can only be withdrawn once; check your withdrawal "
        "history",
    ErrorCode.PROOF_PARSE_ERROR:
        "Regenerate the proof and paste the complete 388-byte proof hex",
    ErrorCode.WITNESS_PARSE_ERROR:
        "The public witness blob must be the 12-byte header plus 32 bytes "
        "per public input",
    ErrorCode.PROOF_VERIFICATION_FAILED:
        "Make sure the proof was generated for this exact circuit and "
        "public inputs",
    ErrorCode.AUDIT_RECORD_MISSING:
        "Submit the audit proof first (or use the relayer's combined "
        "audit-then-withdraw flow)",
    ErrorCode.INSUFFICIENT_FUNDS:
        "The pool vault cannot cover this amount; try a smaller withdrawal",
    ErrorCode.INVALID_AMOUNT:
        "Amounts must be positive and within the pool's limits",
    ErrorCode.INVALID_RECIPIENT:
        "Recipient must encode as [0,0] ++ pubkey[0..30]",
    ErrorCode.DEPOSIT_NOT_FOUND:
        "Import your deposit backup or re-derive it from the secret key",
    ErrorCode.STORAGE_ERROR:
        "Check file permissions for the store path and retry",
    ErrorCode.TRANSACTION_FAILED:
        "Please try again; if the issue persists inspect the pool logs",
}

# PoolError message fragments -> codes (the reference parses Solana log
# strings the same way, errors.ts:116-145)
_PARSE_TABLE = [
    ("nullifier already used", ErrorCode.NULLIFIER_ALREADY_USED),
    ("unknown root", ErrorCode.ROOT_EXPIRED),
    ("audit record missing", ErrorCode.AUDIT_RECORD_MISSING),
    ("insufficient funds", ErrorCode.INSUFFICIENT_FUNDS),
    ("bad recipient", ErrorCode.INVALID_RECIPIENT),
    ("bad withdraw payload", ErrorCode.WITNESS_PARSE_ERROR),
    ("bad audit payload", ErrorCode.WITNESS_PARSE_ERROR),
    ("proof verification failed", ErrorCode.PROOF_VERIFICATION_FAILED),
]


class ShieldedPoolError(Exception):
    def __init__(self, code: ErrorCode, message: str | None = None,
                 cause: Exception | None = None):
        self.code = code
        self.recovery_hint = RECOVERY_HINTS[code]
        super().__init__(message or MESSAGES[code])
        self.__cause__ = cause


def parse_pool_error(err: Exception) -> ShieldedPoolError:
    """Classify a raw error (PoolError or anything else) into a typed
    ShieldedPoolError with a recovery hint."""
    if isinstance(err, ShieldedPoolError):
        return err
    msg = str(err).lower()
    if isinstance(err, PoolError):
        for frag, code in _PARSE_TABLE:
            if frag in msg:
                return ShieldedPoolError(code, str(err), err)
    return ShieldedPoolError(ErrorCode.TRANSACTION_FAILED, str(err), err)


@dataclass(frozen=True)
class StatusMessage:
    type: str                      # idle | loading | success | error | warning
    message: str
    hint: str | None = None


def status(type_: str, message: str, hint: str | None = None) -> StatusMessage:
    return StatusMessage(type_, message, hint)


def error_status(err: Exception) -> StatusMessage:
    e = parse_pool_error(err)
    return StatusMessage("error", str(e), e.recovery_hint)
