"""Client-side persistence: deposits, Merkle tree state, audit logs (C23).

The port's copy of ``tpu_zkpool/protocol/storage.py`` (host code; the same
JSON file format, version 3, so a store written by either package opens in
the other). ``deposit_record_from_flow`` reads the sibling path from the
port's ``MerkleTree.get_proof``: the tree's levels built on its device.

Our equivalent of the reference's IndexedDB v3 store
(``demo-frontend/app/lib/storage.ts:9-129,233-250``): the same record
schema (full witness material including RLWE ciphertext/noise/quotients),
a singleton Merkle-tree state, append-only audit logs, and
export/import — persisted as an atomic JSON file keyed per pool. Field
values are hex strings for bigint-safe serialization, exactly as the
reference stores them.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, asdict

from tpu_zkpool_torch.protocol.errors import ErrorCode, ShieldedPoolError

_DEFAULT_PATH = os.path.expanduser(
    "~/.local/share/tpu_zkpool_torch/store.json")


@dataclass
class DepositRecord:
    """storage.ts DepositRecord (hex-string fields, same names)."""

    id: str                        # commitment hash (primary key)
    secret_key: str
    public_key_x: str
    public_key_y: str
    amount: str
    randomness: str
    commitment: str
    leaf_index: int
    root: str
    nullifier: str
    wa_commitment: str
    siblings: list
    recipient: str = ""
    created_at: float = 0.0
    status: str = "pending"        # pending | withdrawn
    tx_signature: str | None = None
    withdraw_tx_signature: str | None = None
    rlwe_ciphertext: dict | None = None   # {c0_sparse: [hex], c1: [hex]}
    rlwe_noise: dict | None = None        # {r, e1_sparse, e2}
    rlwe_quotients: dict | None = None    # {k0, k1}
    ct_commitment: str | None = None


@dataclass
class MerkleTreeState:
    leaves: list = field(default_factory=list)
    last_synced_root: str = "0x0"
    last_updated: float = 0.0


class Store:
    """Atomic JSON-file store with the reference's three tables."""

    def __init__(self, path: str = _DEFAULT_PATH):
        self.path = path
        self._data = {"version": 3, "deposits": {}, "merkle_tree": None,
                      "audit_logs": []}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self._data = json.load(f)
            except Exception as e:
                raise ShieldedPoolError(ErrorCode.STORAGE_ERROR,
                                        f"corrupt store at {path}", e)

    def _flush(self):
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._data, f)
            os.replace(tmp, self.path)
        except OSError as e:
            raise ShieldedPoolError(ErrorCode.STORAGE_ERROR, str(e), e)

    # ------------------------------------------------------------ deposits

    def save_deposit(self, rec: DepositRecord) -> None:
        if not rec.created_at:
            rec.created_at = time.time()
        self._data["deposits"][rec.id] = asdict(rec)
        self._flush()

    def get_deposit(self, commitment: str) -> DepositRecord:
        raw = self._data["deposits"].get(commitment)
        if raw is None:
            raise ShieldedPoolError(ErrorCode.DEPOSIT_NOT_FOUND)
        return DepositRecord(**raw)

    def all_deposits(self, status: str | None = None) -> list:
        out = [DepositRecord(**r) for r in self._data["deposits"].values()]
        if status is not None:
            out = [r for r in out if r.status == status]
        return sorted(out, key=lambda r: r.created_at)

    def mark_withdrawn(self, commitment: str, tx_signature: str = "") -> None:
        rec = self.get_deposit(commitment)
        rec.status = "withdrawn"
        rec.withdraw_tx_signature = tx_signature
        self.save_deposit(rec)

    # ---------------------------------------------------------- merkle tree

    def save_merkle_state(self, leaves: list, root: str) -> None:
        self._data["merkle_tree"] = asdict(MerkleTreeState(
            leaves=list(leaves), last_synced_root=root,
            last_updated=time.time()))
        self._flush()

    def merkle_state(self) -> MerkleTreeState | None:
        raw = self._data["merkle_tree"]
        return MerkleTreeState(**raw) if raw else None

    # ----------------------------------------------------------- audit log

    def log_audit(self, nullifier: str, wa_commitment: str,
                  ct_commitment: str, tx_signature: str = "") -> None:
        self._data["audit_logs"].append({
            "id": len(self._data["audit_logs"]) + 1,
            "nullifier": nullifier, "wa_commitment": wa_commitment,
            "ct_commitment": ct_commitment, "tx_signature": tx_signature,
            "timestamp": time.time(),
        })
        self._flush()

    def audit_logs(self) -> list:
        return list(self._data["audit_logs"])

    # -------------------------------------------------------- export/import

    def export_data(self) -> dict:
        """storage.ts exportData: deposits + merkle tree state."""
        return {"deposits": list(self._data["deposits"].values()),
                "merkle_tree": self._data["merkle_tree"]}

    def import_deposits(self, deposits: list) -> None:
        for raw in deposits:
            rec = raw if isinstance(raw, dict) else asdict(raw)
            self._data["deposits"][rec["id"]] = rec
        self._flush()

    def clear_all(self) -> None:
        self._data["deposits"] = {}
        self._data["merkle_tree"] = None
        self._flush()


def deposit_record_from_flow(note, tree, leaf_index: int,
                             enc: dict | None = None,
                             ct_commitment: int | None = None) -> DepositRecord:
    """Build a DepositRecord from a flows.Note + MerkleTree (its sibling
    path from ``tree.get_proof``: kernel K7 on a CUDA tree), mirroring
    storage.ts's createDepositRecord (full witness material retained)."""
    h = lambda v: hex(int(v))
    ident = note.identity
    rec = DepositRecord(
        id=h(note.commitment), secret_key=h(ident.secret_key),
        public_key_x=h(ident.owner_x), public_key_y=h(ident.owner_y),
        amount=str(note.amount), randomness=h(note.randomness),
        commitment=h(note.commitment), leaf_index=leaf_index,
        root=h(tree.get_root()), nullifier=h(note.nullifier(leaf_index)),
        wa_commitment=h(ident.wa_commitment),
        siblings=[h(s) for s in tree.get_proof(leaf_index)],
    )
    if enc is not None:
        rec.rlwe_ciphertext = {"c0_sparse": [h(v) for v in enc["c0_sparse"]],
                               "c1": [h(v) for v in enc["c1"]]}
        rec.rlwe_noise = {"r": [str(v) for v in enc["r_signed"]],
                          "e1_sparse": [str(v) for v in enc["e1_signed"]],
                          "e2": [str(v) for v in enc["e2_signed"]]}
        rec.rlwe_quotients = {"k0": [str(v) for v in enc["k0"]],
                              "k1": [str(v) for v in enc["k1"]]}
    if ct_commitment is not None:
        rec.ct_commitment = h(ct_commitment)
    return rec
