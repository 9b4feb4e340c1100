#!/usr/bin/env python3
"""Shielded-pool demo console on the PyTorch/CUDA port — the L6 demo-UI
equivalent (C26).

The port's counterpart of ``examples/demo_cli.py``, the same journey over
``tpu_zkpool_torch``: the Merkle tree lives on the device (``cuda`` unless
``--device`` names another; without a GPU the script raises), so every
sibling path comes from ``build_levels`` through kernel K7. The auditor
key directory is ``--rlwe-dir`` (the reference checkout's
``demo-frontend/public/rlwe`` from its root by default;
``tpu_zkpool_torch.webui.write_rlwe_dir`` writes one).

The terminal analogue of ``demo-frontend/app/components/
shielded-pool-card.tsx``: drives the full user journey with the same
surfaces the browser card exposes — deposit (identity keygen + RLWE
encryption inline), root-age display, audit submission, relayer
withdrawal, the audit-history table, and auditor Shamir decryption — using
the framework's storage (C23), typed errors with recovery hints (C24),
and proof-hex tooling (C20). Proof generation/verification is wired
through lightweight stub verifiers by default so the demo runs in
seconds; the real proving pipeline lives in withdraw_e2e.py / audit_e2e.py.

Usage: python examples/torch_demo_cli.py [--store PATH] [--rlwe-dir DIR]
[--device cpu]
"""

import argparse
import json
import os
import secrets
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_zkpool_torch.merkle.tree import MerkleTree  # noqa: E402
from tpu_zkpool_torch.protocol import flows, storage as stg  # noqa: E402
from tpu_zkpool_torch.protocol.errors import (  # noqa: E402
    error_status, status)
from tpu_zkpool_torch.protocol.relayer import Relayer  # noqa: E402
from tpu_zkpool_torch.protocol.state import (  # noqa: E402
    PROOF_LEN, Pool, PoolError)
from tpu_zkpool_torch.protocol.audit_circuit import (  # noqa: E402
    ct_commitment_of)
from tpu_zkpool_torch.refimpl import rlwe_ref  # noqa: E402
from tpu_zkpool_torch.utils.metrics import Metrics  # noqa: E402
from tpu_zkpool_torch.webui.app import DEFAULT_RLWE_DIR  # noqa: E402


def banner(txt):
    print(f"\n{'=' * 64}\n {txt}\n{'=' * 64}", flush=True)


def show(st):
    icon = {"success": "[ok]", "error": "[err]", "loading": "[..]",
            "warning": "[!]"}.get(st.type, "[--]")
    print(f"  {icon} {st.message}" + (f"\n       hint: {st.hint}"
                                      if st.hint else ""), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=os.path.join(
        tempfile.gettempdir(), "tpu_zkpool_torch_demo_store.json"))
    ap.add_argument("--rlwe-dir", default=DEFAULT_RLWE_DIR)
    ap.add_argument("--device", default=None, help="default cuda")
    args = ap.parse_args(argv)
    if os.path.exists(args.store):
        os.remove(args.store)

    timer = Metrics()
    store = stg.Store(args.store)
    tree = MerkleTree(device=args.device)
    pool = Pool(withdraw_verifier=lambda p, w: True,
                audit_verifier=lambda p, w: True)
    pool.initialize()
    relayer = Relayer(pool)

    banner("1. Deposit — identity keygen + note commitment + RLWE encrypt")
    with timer.timer("deposit"):
        ident = flows.Identity.generate()
        note = flows.Note(ident, amount=5_000_000,
                          randomness=secrets.randbits(200))
        idx = tree.insert(note.commitment)
        pool.deposit(payer_balance=10_000_000, amount=note.amount,
                     commitment=note.commitment, new_root=tree.get_root())

        with open(os.path.join(args.rlwe_dir, "rlwe_pk.json")) as f:
            pk = json.load(f)
        a_pk = [int(v, 16) for v in pk["a"]]
        b_pk = [int(v, 16) for v in pk["b"]]
        enc = rlwe_ref.encrypt(a_pk, b_pk, ident.owner_x, ident.owner_y,
                               seed=secrets.randbits(30))
        ct = ct_commitment_of(enc)
        rec = stg.deposit_record_from_flow(note, tree, idx, enc, ct)
        store.save_deposit(rec)
        store.save_merkle_state([hex(v) for v in tree.leaves],
                                hex(tree.get_root()))
    show(status("success", f"deposited {note.amount} lamports; "
                f"leaf {idx}, commitment {rec.commitment[:18]}..."))
    age = pool.state.root_age(tree.get_root())
    show(status("success", f"root age {age} (32-root window)"))

    banner("2. Relayed withdraw — audit tx then withdraw tx")
    with timer.timer("withdraw"):
        wit = flows.build_withdraw_witness(
            tree, note, idx, recipient_pubkey=b"\x07" * 32,
            amount=note.amount)
        audit_blob = flows.audit_witness_blob(ident.wa_commitment, ct)
        res = relayer.relay_withdraw(
            b"\x01" * PROOF_LEN, wit.witness_blob(),
            b"\x02" * PROOF_LEN, audit_blob)
        store.mark_withdrawn(rec.id, "relayed")
        store.log_audit(hex(wit.nullifier), rec.wa_commitment, hex(ct),
                        "relayed")
    show(status("success", f"withdrew {res.amount} to "
                f"{res.recipient.hex()[:16]}... "
                f"(audit {'new' if res.audit_was_new else 'existing'})"))
    show(status("success", f"relayer health: {relayer.status()}"))

    banner("3. Double-spend attempt — typed error with recovery hint")
    try:
        relayer.relay_withdraw(b"\x01" * PROOF_LEN, wit.witness_blob(),
                               b"\x02" * PROOF_LEN, audit_blob)
    except PoolError as e:
        show(error_status(e))

    banner("4. Audit history + auditor decryption (Shamir 2-of-3)")
    for row in store.audit_logs():
        print(f"  #{row['id']}  nullifier {row['nullifier'][:18]}... "
              f"wa {row['wa_commitment'][:18]}...", flush=True)
    with timer.timer("decrypt"):
        shares = []
        for i in (1, 2):
            with open(os.path.join(args.rlwe_dir, "rlwe_sk_shares",
                                   f"share_{i}.json")) as f:
                shares.append(json.load(f))
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
    assert (x, y) == (ident.owner_x, ident.owner_y)
    show(status("success", "auditor recovered the depositor identity "
                "exactly (owner_x/owner_y match)"))

    for name, t in timer.snapshot()["timings"].items():
        print(f"[demo] {name}: {t['total_s']:.2f}s", flush=True)
    print("\nDEMO OK", flush=True)


if __name__ == "__main__":
    main()
