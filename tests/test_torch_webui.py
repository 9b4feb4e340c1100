"""Port parity: the demo web UI (``tpu_zkpool_torch.webui``), the journey of
``tests/test_webui.py`` through the real HTTP stack on the CPU.

The auditor key directory is written by the app's ``write_rlwe_dir`` from
the port's ``refimpl.rlwe_ref.keygen(42)`` in the reference's JSON layout
(``rlwe_pk.json``: ``{"a": [hex], "b": [hex]}``;
``rlwe_sk_shares/share_{i}.json``: ``{"coefficients": [{"x", "y"}]}``), so
nothing is read from outside the repository. The app's tree lives on the
CPU here (``device="cpu"``); ``prover="groth16"`` without its artifact
raises, and so does an app with no device named and no CUDA, or with no
key directory.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from tpu_zkpool_torch.hash.poseidon_params import poseidon_hash_ref
from tpu_zkpool_torch.merkle import MerkleTree
from tpu_zkpool_torch.protocol import errors as er
from tpu_zkpool_torch.webui import DemoApp, make_server, write_rlwe_dir


@pytest.fixture(scope="module")
def rlwe_dir(tmp_path_factory):
    return write_rlwe_dir(str(tmp_path_factory.mktemp("rlwe")))


@pytest.fixture(scope="module")
def server(tmp_path_factory, rlwe_dir):
    store = tmp_path_factory.mktemp("webui") / "store.json"
    app = DemoApp(store_path=str(store), rlwe_dir=rlwe_dir, fresh=True,
                  device="cpu")
    srv = make_server(app, port=0)   # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", app
    srv.shutdown()
    srv.server_close()


def call(base, method, path, body=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_full_journey(server, rlwe_dir):
    base, app = server
    # landing page served
    with urllib.request.urlopen(base + "/") as r:
        assert r.status == 200 and b"shielded pool" in r.read()

    st = call(base, "GET", "/api/status")[1]
    assert st["leaves"] == 0 and st["prover"] == "stub"

    code, dep = call(base, "POST", "/api/deposit", {"amount": 5_000_000})
    assert code == 200 and dep["leaf_index"] == 0
    assert dep["ct_commitment"] is not None

    st = call(base, "GET", "/api/status")[1]
    assert st["leaves"] == 1 and st["root_age"] == 0
    assert st["pool_root"] == dep["root"]

    # the stored record against the host oracles
    rec = app.store.get_deposit(dep["commitment"])
    fields = [int(v, 16) for v in (rec.public_key_x, rec.public_key_y)]
    assert int(rec.commitment, 16) == poseidon_hash_ref(
        fields + [int(rec.amount), int(rec.randomness, 16)])
    assert MerkleTree.verify_proof(int(rec.commitment, 16), 0,
                                   [int(v, 16) for v in rec.siblings],
                                   int(rec.root, 16))

    rcpt = "07" * 32
    code, wd = call(base, "POST", "/api/withdraw",
                    {"commitment": dep["commitment"], "recipient": rcpt})
    assert code == 200 and wd["amount"] == 5_000_000
    # recipient comes back in the reference's on-chain encoding:
    # [0,0] ++ pubkey[0..30] (withdraw.rs:149-154)
    assert wd["recipient"] == "0000" + rcpt[:60] and wd["audit_was_new"]

    # double spend -> typed error with recovery hint (C24)
    code, err = call(base, "POST", "/api/withdraw",
                     {"commitment": dep["commitment"], "recipient": rcpt})
    assert code == 400 and "nullifier" in err["error"]
    assert err["hint"] == er.RECOVERY_HINTS[
        er.ErrorCode.NULLIFIER_ALREADY_USED]

    code, dec = call(base, "POST", "/api/decrypt",
                     {"commitment": dep["commitment"]})
    assert code == 200 and dec["matches_deposit"]

    deps = call(base, "GET", "/api/deposits")[1]["deposits"]
    assert len(deps) == 1 and deps[0]["status"] == "withdrawn"
    audits = call(base, "GET", "/api/audits")[1]["audits"]
    assert len(audits) == 1 and audits[0]["nullifier"] == wd["nullifier"]

    assert call(base, "GET", "/api/nope")[0] == 404

    # a second app on the same store rebuilds the same leaves and root,
    # and decrypts from the stored ciphertext
    again = DemoApp(store_path=app.store.path, rlwe_dir=rlwe_dir,
                    device="cpu")
    assert again.tree.leaves == app.tree.leaves
    assert again.tree.get_root() == app.tree.get_root()
    assert again.status()["root_age"] == 0
    assert again.decrypt(dep["commitment"])["matches_deposit"]


def test_groth16_prover_raises(tmp_path, rlwe_dir):
    """``prover="groth16"`` without its ACIR artifact fails at startup (it
    never falls back to the stub), as does a prover the app does not
    know; neither creates the store."""
    with pytest.raises(FileNotFoundError, match="withdraw_acir.py"):
        DemoApp(store_path=str(tmp_path / "s.json"), rlwe_dir=rlwe_dir,
                prover="groth16", device="cpu",
                artifact=str(tmp_path / "none.json"))
    with pytest.raises(FileNotFoundError, match="shielded_pool_verifier"):
        DemoApp(store_path=str(tmp_path / "s.json"), rlwe_dir=rlwe_dir,
                prover="groth16", device="cpu")
    with pytest.raises(ValueError, match="unknown prover 'plonk'"):
        DemoApp(store_path=str(tmp_path / "s.json"), rlwe_dir=rlwe_dir,
                prover="plonk", device="cpu")
    assert not (tmp_path / "s.json").exists()


def test_app_asks_for_cuda(tmp_path, monkeypatch, rlwe_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DemoApp(store_path=str(tmp_path / "s.json"), rlwe_dir=rlwe_dir)
    app = DemoApp(store_path=str(tmp_path / "s.json"), rlwe_dir=rlwe_dir,
                  device="cpu")
    assert app.tree.device.type == "cpu"


def test_missing_key_directory_fails_at_startup(tmp_path, monkeypatch):
    store = tmp_path / "s.json"
    with pytest.raises(FileNotFoundError, match="rlwe_pk.json"):
        DemoApp(store_path=str(store), rlwe_dir=str(tmp_path / "none"),
                device="cpu")
    monkeypatch.chdir(tmp_path)          # the default, relative directory
    with pytest.raises(FileNotFoundError, match="write_rlwe_dir"):
        DemoApp(store_path=str(store), device="cpu")
    write_rlwe_dir(str(tmp_path / "keys"))
    (tmp_path / "keys" / "rlwe_sk_shares" / "share_2.json").unlink()
    with pytest.raises(FileNotFoundError, match="share_2.json"):
        DemoApp(store_path=str(store), rlwe_dir=str(tmp_path / "keys"),
                device="cpu")
    assert not store.exists()


def test_concurrent_withdrawals_of_one_note(tmp_path, rlwe_dir):
    """Two withdrawals of one note sent at once: exactly one is paid. The
    verifier is slowed (as the device verifier of ``prover="groth16"``
    takes tens of ms), so the second request arrives while the first is
    between the pool's nullifier check and its record."""
    app = DemoApp(store_path=str(tmp_path / "s.json"), rlwe_dir=rlwe_dir,
                  fresh=True, device="cpu")
    verify = app.pool.withdraw_verifier

    def slow_verifier(proof, witness):
        time.sleep(0.3)
        return verify(proof, witness)

    app.pool.withdraw_verifier = slow_verifier
    srv = make_server(app, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        # two notes, so the vault could pay the first one out twice
        for _ in range(2):
            st, dep = call(base, "POST", "/api/deposit",
                           {"amount": 5_000_000})
            assert st == 200
        vault = app.pool.vault_lamports
        start = threading.Barrier(2)
        results = []

        def withdraw(recipient):
            start.wait()
            results.append(call(base, "POST", "/api/withdraw",
                                {"commitment": dep["commitment"],
                                 "recipient": recipient}))

        threads = [threading.Thread(target=withdraw, args=(r,))
                   for r in ("0000" + "ab" * 30, "0000" + "cd" * 30)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        srv.shutdown()
        srv.server_close()
    assert sorted(st for st, _ in results) == [200, 400]
    refused = next(body for st, body in results if st == 400)
    assert refused["hint"] == er.RECOVERY_HINTS[
        er.ErrorCode.NULLIFIER_ALREADY_USED]
    assert app.pool.vault_lamports == vault - 5_000_000
    assert len(app.pool.nullifiers) == 1
