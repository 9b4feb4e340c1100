"""Demo-UI application logic: one object per browser session's state.

The port of ``tpu_zkpool/webui/app.py``. Maps the reference UI's handlers
onto the framework:

- ``deposit``      -> ``handleDeposit`` (shielded-pool-card.tsx:267-376):
  identity keygen, note commitment, Merkle insert, pool deposit ix, inline
  RLWE encryption of the owner point, persisted DepositRecord.
- ``withdraw``     -> ``handleWithdraw`` + relayer POST
  (card.tsx:424-514, api/relay/withdraw/route.ts:88-309): witness assembly,
  proof generation, audit-then-withdraw two-tx relay.
- ``decrypt``      -> the Shamir "Decrypt" button (card.tsx:667-681,
  app/lib/shamir.ts:97-179): reconstruct sk from shares 1+2, decrypt the
  stored ciphertext, recover the depositor identity.
- ``status``       -> root-age display + relayer health
  (card.tsx:390-399, api/relay/status/route.ts:38-57).
- ``audit_logs`` / ``deposits`` -> the history tables (card.tsx:745+).

The pool's Merkle tree lives on the app's device (``cuda`` unless the
caller names another; raises without a GPU), so each deposit's and each
withdraw's sibling path comes from ``build_levels`` there (kernel K7 on the
card). The RLWE encryption and ``ct_commitment`` of a deposit run on the
host references, as in the JAX app.

Proofs come from the stub prover by default (instant, verifier accepts any
bytes). ``prover="groth16"`` proves each withdrawal for real from the
withdraw circuit's ACIR artifact (``artifact``; the reference checkout's,
from its root, by default): at startup the app loads and converts the
circuit, runs ``cached_setup`` and uploads one ``DeviceProvingKey`` to its
device; each withdrawal is solved natively (``solver_native.solve``),
extended to the R1CS witness (``r1cs.build_witness``), proved on the
device (``groth16.prove``: K1-K6 on the card) with fresh blinding, and
verified by the pool through ``verify_batch`` (P1 and P2). Malformed proof
bytes are a failed verification. The app never falls back to the stub
when ``groth16`` was asked for: without the artifact it fails at startup.
"""

from __future__ import annotations

import json
import os
import secrets
import struct
import tempfile
import threading
import time

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.groth16 import r1cs as r1cs_mod
from tpu_zkpool_torch.groth16 import solver_native
from tpu_zkpool_torch.groth16.acir import load_artifact
from tpu_zkpool_torch.groth16.cache import cached_setup
from tpu_zkpool_torch.groth16.gnark_fmt import (emit_proof, parse_proof,
                                                parse_public_witness)
from tpu_zkpool_torch.groth16.prove import DeviceProvingKey, prove
from tpu_zkpool_torch.groth16.verify import verify_batch
from tpu_zkpool_torch.merkle.tree import MerkleTree
from tpu_zkpool_torch.protocol import flows, storage as stg
from tpu_zkpool_torch.protocol.audit_circuit import ct_commitment_of
from tpu_zkpool_torch.protocol.errors import error_status
from tpu_zkpool_torch.protocol.relayer import Relayer
from tpu_zkpool_torch.protocol.state import Pool, PROOF_LEN
from tpu_zkpool_torch.refimpl import rlwe_ref

# The auditor key directory of the reference repository, relative to its
# checkout's root (the JAX app names that checkout by an absolute path).
DEFAULT_RLWE_DIR = os.path.join("demo-frontend", "public", "rlwe")
# The withdraw circuit's ACIR artifact, relative to the same checkout's root.
DEFAULT_ARTIFACT = os.path.join("noir_circuit", "target",
                                "shielded_pool_verifier.json")
PROVERS = ("stub", "groth16")
# the withdraw witness blob's header (nbPublic, nbSecret, vectorLen),
# withdraw.rs:70-90
WITHDRAW_HEADER = (5, 0, 5)
DEFAULT_STORE = os.path.join(tempfile.gettempdir(),
                             "tpu_zkpool_torch_webui_store.json")


# The auditor key directory's layout, the reference's JSON files:
# rlwe_pk.json {"a": [hex], "b": [hex]} and rlwe_sk_shares/share_{i}.json
# {"coefficients": [{"x": i, "y": hex}]}.
def _pk_path(rlwe_dir: str) -> str:
    return os.path.join(rlwe_dir, "rlwe_pk.json")


def _share_path(rlwe_dir: str, i: int) -> str:
    return os.path.join(rlwe_dir, "rlwe_sk_shares", f"share_{i}.json")


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def write_rlwe_dir(path: str, seed: int = 42) -> str:
    """Write an auditor key directory in the reference's layout from
    ``rlwe_ref.keygen(seed)``: the public key and every Shamir share."""
    kg = rlwe_ref.keygen(seed)
    os.makedirs(os.path.dirname(_share_path(path, 1)), exist_ok=True)
    with open(_pk_path(path), "w") as f:
        json.dump({"a": [hex(v) for v in kg["a"]],
                   "b": [hex(v) for v in kg["b"]]}, f)
    for i, share in enumerate(kg["shares"], start=1):
        with open(_share_path(path, i), "w") as f:
            json.dump({"coefficients": [{"x": x, "y": hex(y)}
                                        for x, y in share]}, f)
    return path


class WithdrawCircuit:
    """The withdraw circuit of an ACIR artifact, set up for proving on a
    device: the program, its R1CS (``r1cs.convert``), the cached Groth16
    keys and the proving key's query points on the device."""

    def __init__(self, artifact: str, device):
        _, self.program = load_artifact(artifact)
        self.ar = r1cs_mod.convert(self.program)
        self.pk, self.vk = cached_setup(self.ar.r1cs)
        self.dpk = DeviceProvingKey(self.pk, device=device)
        self.device = self.dpk.device

    def prove(self, acir_inputs: dict, timings: dict) -> tuple:
        """(A, B2, C) for one assignment of the ACIR inputs; ``timings``
        receives the seconds of the native solve, the R1CS witness and the
        device proof. The blinding is fresh for every proof."""
        clock = time.perf_counter
        t0 = clock()
        w_acir = solver_native.solve(self.program, acir_inputs)
        t1 = clock()
        w = r1cs_mod.build_witness(self.ar, w_acir)
        t2 = clock()
        proof = prove(self.dpk, self.ar.r1cs, w, seed=secrets.randbits(128))
        timings.update(solve_s=t1 - t0, witness_s=t2 - t1,
                       prove_s=clock() - t2)
        return proof

    def verify(self, proof_bytes: bytes, witness_bytes: bytes) -> bool:
        """The pool's withdraw verifier: the wire-format proof against the
        public inputs of the witness blob, through ``verify_batch``.
        Malformed bytes (a point off its curve or outside G2's subgroup, a
        coordinate not below p, the identity, a witness header other than
        the withdraw's (5, 0, 5)) fail verification rather than raise, as
        the reference's verifier CPI fails the instruction
        (withdraw.rs:163-175)."""
        try:
            pf = parse_proof(proof_bytes)
            if struct.unpack(">III", witness_bytes[:12]) != WITHDRAW_HEADER:
                return False
            vals = parse_public_witness(witness_bytes)
        except (ValueError, struct.error):
            return False
        if None in (pf.ar, pf.bs, pf.krs):
            return False
        return bool(verify_batch(self.vk, [(pf.ar, pf.bs, pf.krs)], [vals],
                                 device=self.device)[0])


class DemoApp:
    def __init__(self, store_path: str = DEFAULT_STORE,
                 rlwe_dir: str = DEFAULT_RLWE_DIR, prover: str = "stub",
                 fresh: bool = False, device=None,
                 artifact: str = DEFAULT_ARTIFACT):
        if prover not in PROVERS:
            raise ValueError(f"unknown prover {prover!r}, not one of "
                             f"{PROVERS}")
        self.device = resolve_device(device)
        for need in (_pk_path(rlwe_dir), _share_path(rlwe_dir, 1),
                     _share_path(rlwe_dir, 2)):
            if not os.path.isfile(need):
                raise FileNotFoundError(
                    f"auditor key directory {rlwe_dir!r} lacks {need!r} "
                    f"(write one with webui.app.write_rlwe_dir)")
        if prover == "groth16" and not os.path.isfile(artifact):
            raise FileNotFoundError(
                f"prover='groth16' needs the withdraw circuit's ACIR artifact;"
                f" {artifact!r} is missing (scripts/withdraw_acir.py writes "
                f"one)")
        # the HTTP server runs a thread a request. A deposit and a withdraw
        # each run whole under this lock: the pool checks a nullifier, then
        # verifies, then records it, so two withdrawals of one note must not
        # overlap; and the device prover and verifier are not reentrant
        self._lock = threading.Lock()
        self._verify_s = None
        self.circuit = (WithdrawCircuit(artifact, self.device)
                        if prover == "groth16" else None)
        if fresh and os.path.exists(store_path):
            os.remove(store_path)
        self.store = stg.Store(store_path)
        self.rlwe_dir = rlwe_dir
        self.prover = prover
        self.tree = MerkleTree(device=self.device)
        self._enc_cache: dict[str, dict] = {}
        # rebuild the tree from persisted leaves (storage.ts:189-206)
        st = self.store.merkle_state()
        if st:
            for leaf in st.leaves:
                self.tree.insert(int(leaf, 16))
        verifier = (self._verify if self.circuit is not None
                    else lambda proof, witness: True)
        self.pool = Pool(withdraw_verifier=verifier,
                         audit_verifier=lambda p, w: True)
        self.pool.initialize()
        if st:
            self.pool.state.add_root(self.tree.get_root())
        self.relayer = Relayer(self.pool)

    # ------------------------------------------------------------- proving

    def _prove_withdraw(self, wit: flows.WithdrawWitness,
                        timings: dict) -> bytes:
        if self.circuit is None:
            return b"\x01" * PROOF_LEN          # the stub prover
        proof = self.circuit.prove(wit.acir_inputs(), timings)
        # the wire layout with one commitment slot and a proof of knowledge
        # (placeholders, as the JAX app emits): 388 bytes, PROOF_LEN
        return emit_proof(proof[0], proof[1], proof[2], [(1, 2)], (1, 2))

    def _verify(self, proof_bytes: bytes, witness_bytes: bytes) -> bool:
        t0 = time.perf_counter()
        ok = self.circuit.verify(proof_bytes, witness_bytes)
        self._verify_s = time.perf_counter() - t0
        return ok

    # ----------------------------------------------------------- endpoints

    def status(self) -> dict:
        root = self.tree.get_root()
        return {
            "pool_root": hex(root),
            "root_age": self.pool.state.root_age(root),
            "leaves": len(self.tree.leaves),
            "vault_lamports": self.pool.vault_lamports,
            "relayer": self.relayer.status(),
            "prover": self.prover,
        }

    def deposit(self, amount: int) -> dict:
        with self._lock:
            return self._deposit(amount)

    def withdraw(self, commitment: str, recipient_hex: str) -> dict:
        with self._lock:
            return self._withdraw(commitment, recipient_hex)

    def _deposit(self, amount: int) -> dict:
        t0 = time.time()
        ident = flows.Identity.generate()
        note = flows.Note(ident, amount=int(amount),
                          randomness=secrets.randbits(200))
        idx = self.tree.insert(note.commitment)
        self.pool.deposit(payer_balance=int(amount) + 10_000_000,
                          amount=note.amount, commitment=note.commitment,
                          new_root=self.tree.get_root())
        pk = _read_json(_pk_path(self.rlwe_dir))
        enc = rlwe_ref.encrypt([int(v, 16) for v in pk["a"]],
                               [int(v, 16) for v in pk["b"]],
                               ident.owner_x, ident.owner_y,
                               seed=secrets.randbits(30))
        ct = ct_commitment_of(enc)
        rec = stg.deposit_record_from_flow(note, self.tree, idx, enc, ct)
        self.store.save_deposit(rec)
        self.store.save_merkle_state([hex(v) for v in self.tree.leaves],
                                     hex(self.tree.get_root()))
        self._enc_cache[rec.id] = enc
        return {"commitment": rec.commitment, "leaf_index": idx,
                "root": rec.root, "wa_commitment": rec.wa_commitment,
                "ct_commitment": rec.ct_commitment,
                "elapsed_s": round(time.time() - t0, 3)}

    def _withdraw(self, commitment: str, recipient_hex: str) -> dict:
        t0 = time.time()
        rec = self.store.get_deposit(commitment)
        note = flows.Note(
            flows.Identity(int(rec.secret_key, 16), int(rec.public_key_x, 16),
                           int(rec.public_key_y, 16)),
            amount=int(rec.amount), randomness=int(rec.randomness, 16))
        recipient = bytes.fromhex(recipient_hex.removeprefix("0x"))
        if len(recipient) != 32:
            recipient = recipient.ljust(32, b"\x00")
        wit = flows.build_withdraw_witness(
            self.tree, note, rec.leaf_index, recipient_pubkey=recipient,
            amount=note.amount)
        timings: dict = {}
        proof = self._prove_withdraw(wit, timings)
        self._verify_s = None
        audit_blob = flows.audit_witness_blob(
            int(rec.wa_commitment, 16), int(rec.ct_commitment or "0x0", 16))
        res = self.relayer.relay_withdraw(
            proof, wit.witness_blob(), b"\x02" * PROOF_LEN, audit_blob)
        self.store.mark_withdrawn(rec.id, "relayed")
        self.store.log_audit(hex(wit.nullifier), rec.wa_commitment,
                             rec.ct_commitment or "0x0", "relayed")
        if self._verify_s is not None:
            timings["verify_s"] = self._verify_s
        return {"recipient": res.recipient.hex(), "amount": res.amount,
                "audit_was_new": res.audit_was_new,
                "nullifier": hex(wit.nullifier),
                "elapsed_s": round(time.time() - t0, 3),
                "timings": timings}

    def decrypt(self, commitment: str) -> dict:
        rec = self.store.get_deposit(commitment)
        enc = self._enc_cache.get(rec.id)
        if enc is None:
            if not rec.rlwe_ciphertext:
                raise ValueError("no ciphertext stored for this deposit")
            enc = {"c0_sparse": [int(v, 16)
                                 for v in rec.rlwe_ciphertext["c0_sparse"]],
                   "c1": [int(v, 16) for v in rec.rlwe_ciphertext["c1"]]}
        shares = [_read_json(_share_path(self.rlwe_dir, i)) for i in (1, 2)]
        sk_mod_q = []
        for c1v, c2v in zip(shares[0]["coefficients"],
                            shares[1]["coefficients"]):
            v = rlwe_ref.shamir_reconstruct_field(
                [(c1v["x"], int(c1v["y"], 16)),
                 (c2v["x"], int(c2v["y"], 16))])
            sk_mod_q.append(
                rlwe_ref.centered_mod(v, rlwe_ref.BN254_P) % rlwe_ref.RLWE_Q)
        msg = rlwe_ref.decrypt(sk_mod_q, enc["c0_sparse"], enc["c1"])
        x, y = rlwe_ref.decode_bytes(msg)
        match = (hex(x) == rec.public_key_x and hex(y) == rec.public_key_y)
        return {"owner_x": hex(x), "owner_y": hex(y),
                "matches_deposit": match}

    def deposits(self) -> list:
        return [{"commitment": d.commitment, "amount": d.amount,
                 "leaf_index": d.leaf_index, "status": d.status,
                 "wa_commitment": d.wa_commitment,
                 "created_at": d.created_at}
                for d in self.store.all_deposits()]

    def audit_logs(self) -> list:
        return self.store.audit_logs()

    # ------------------------------------------------------------- routing

    def handle(self, method: str, path: str, body: dict) -> tuple[int, dict]:
        """Route an API request; returns (http_status, json_payload)."""
        try:
            if method == "GET" and path == "/api/status":
                return 200, self.status()
            if method == "GET" and path == "/api/deposits":
                return 200, {"deposits": self.deposits()}
            if method == "GET" and path == "/api/audits":
                return 200, {"audits": self.audit_logs()}
            if method == "POST" and path == "/api/deposit":
                return 200, self.deposit(int(body["amount"]))
            if method == "POST" and path == "/api/withdraw":
                return 200, self.withdraw(body["commitment"],
                                          body["recipient"])
            if method == "POST" and path == "/api/decrypt":
                return 200, self.decrypt(body["commitment"])
            return 404, {"error": f"no route {method} {path}"}
        except Exception as e:  # typed errors -> UI status + recovery hint
            st = error_status(e)
            return 400, {"error": st.message, "hint": st.hint,
                         "type": st.type}
