"""Port parity: the host-side client layer of ``tpu_zkpool_torch`` against
``tpu_zkpool``: errors (C24), storage (C23), proof hex (C20), the gnark byte
formats, the setup cache, the config and the metrics and profiling
utilities.

The cases of ``tests/test_client_host.py`` run on the port; beside them,
``error_status`` equals JAX's for the same exceptions, a store written by
either package opens in the other with the same records, ``emit_proof`` is
byte-equal on ``pairing_ref`` points, ``parse_vk`` / ``parse_proof`` /
``parse_public_witness`` equal JAX's on bytes the test assembles (a flipped
byte fails the same way in both), ``circuit_hash`` is the same, and the
config's defaults and TOML loading equal JAX's, any key of JAX's
``[kernel]`` table rejected.
"""

import dataclasses
import json
import os
import random
import struct

import pytest
import torch

from tpu_zkpool import config as jcfg
from tpu_zkpool.groth16 import cache as jcache
from tpu_zkpool.groth16 import gnark_fmt as jgf
from tpu_zkpool.protocol import errors as jer
from tpu_zkpool.protocol import flows as jflows
from tpu_zkpool.protocol import state as jst
from tpu_zkpool.protocol import storage as jstg
from tpu_zkpool.refimpl import groth16_ref as jg16

from tpu_zkpool_torch import config as cfg
from tpu_zkpool_torch.fields.bn254 import FP_MOD, FR_MOD, G1_GX, G1_GY
from tpu_zkpool_torch.groth16 import cache
from tpu_zkpool_torch.groth16 import gnark_fmt as gf
from tpu_zkpool_torch.merkle.tree import MerkleTree
from tpu_zkpool_torch.protocol import errors as er
from tpu_zkpool_torch.protocol import flows
from tpu_zkpool_torch.protocol import proof_hex as ph
from tpu_zkpool_torch.protocol import storage as stg
from tpu_zkpool_torch.protocol.state import PoolError
from tpu_zkpool_torch.refimpl import groth16_ref as g16
from tpu_zkpool_torch.refimpl import pairing_ref as pr
from tpu_zkpool_torch.utils import metrics, profiling

G1GEN = (G1_GX, G1_GY)


def test_error_parse_and_hints():
    e = er.parse_pool_error(PoolError("nullifier already used"))
    assert e.code == er.ErrorCode.NULLIFIER_ALREADY_USED
    assert "once" in e.recovery_hint
    e2 = er.parse_pool_error(PoolError("unknown root"))
    assert e2.code == er.ErrorCode.ROOT_EXPIRED
    e3 = er.parse_pool_error(ValueError("boom"))
    assert e3.code == er.ErrorCode.TRANSACTION_FAILED
    st = er.error_status(PoolError("proof verification failed"))
    assert st.type == "error" and st.hint


@pytest.mark.parametrize("msg", [
    "nullifier already used", "unknown root", "audit record missing",
    "insufficient funds", "bad recipient encoding",
    "bad withdraw payload size", "bad audit payload size",
    "proof verification failed", "vault would drop below rent exemption"])
def test_error_status_equals_jax(msg):
    for mine, theirs in ((PoolError(msg), jst.PoolError(msg)),
                         (ValueError(msg), ValueError(msg)),
                         (er.ShieldedPoolError(er.ErrorCode.STORAGE_ERROR),
                          jer.ShieldedPoolError(jer.ErrorCode.STORAGE_ERROR))):
        got, want = er.error_status(mine), jer.error_status(theirs)
        assert (got.type, got.message, got.hint) == (
            want.type, want.message, want.hint)
        assert er.parse_pool_error(mine).code.value == \
            jer.parse_pool_error(theirs).code.value


class FixedTree:
    def __init__(self, root, siblings):
        self.root, self.siblings = root, list(siblings)

    def get_root(self):
        return self.root

    def get_proof(self, index):
        return list(self.siblings)


def test_storage_roundtrip(tmp_path):
    path = str(tmp_path / "store.json")
    s = stg.Store(path)
    ident = flows.Identity.generate(12345)
    note = flows.Note(ident, amount=1_000_000, randomness=777)
    tree = MerkleTree(device="cpu")
    idx = tree.insert(note.commitment)
    rec = stg.deposit_record_from_flow(note, tree, idx)
    s.save_deposit(rec)
    s.save_merkle_state([hex(l) for l in tree.leaves], hex(tree.get_root()))
    s.log_audit("0x1", rec.wa_commitment, "0x2", "sig")
    assert MerkleTree.verify_proof(note.commitment, idx,
                                   [int(v, 16) for v in rec.siblings],
                                   int(rec.root, 16))

    s2 = stg.Store(path)   # reload from disk
    got = s2.get_deposit(rec.id)
    assert got.secret_key == hex(12345) and got.leaf_index == idx
    assert got.nullifier == hex(note.nullifier(idx))
    assert s2.merkle_state().last_synced_root == hex(tree.get_root())
    assert len(s2.audit_logs()) == 1

    # status transitions + filtered listing
    assert s2.all_deposits(status="pending")
    s2.mark_withdrawn(rec.id, "txsig")
    assert not s2.all_deposits(status="pending")
    assert s2.get_deposit(rec.id).withdraw_tx_signature == "txsig"

    # export / import (storage.ts:233-250)
    dump = s2.export_data()
    s3 = stg.Store(str(tmp_path / "other.json"))
    s3.import_deposits(dump["deposits"])
    assert s3.get_deposit(rec.id).commitment == rec.commitment

    with pytest.raises(stg.ShieldedPoolError):
        s3.get_deposit("0xdead")


def _enc(rng):
    return {k: [rng.randrange(1 << 27) for _ in range(5)] for k in (
        "c0_sparse", "c1", "r_signed", "e1_signed", "e2_signed", "k0",
        "k1")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_files_open_in_both_packages(tmp_path, writer):
    """A store written by one package's ``Store`` opens in the other's with
    the same deposits, tree state and audit log."""
    rng = random.Random(len(writer))
    mods = ((jflows, jstg), (flows, stg))
    (wflows, wstg), (_, rstg) = mods if writer == "jax" else mods[::-1]
    path = str(tmp_path / "store.json")
    s = wstg.Store(path)
    recs = []
    for i in range(3):
        note = wflows.Note(wflows.Identity.generate(rng.getrandbits(128)),
                           amount=rng.randrange(1, 1 << 30),
                           randomness=rng.getrandbits(200))
        tree = FixedTree(rng.getrandbits(250),
                         [rng.getrandbits(250) for _ in range(16)])
        rec = wstg.deposit_record_from_flow(note, tree, i, _enc(rng),
                                            rng.getrandbits(250))
        s.save_deposit(rec)
        recs.append(dataclasses.asdict(rec))
    s.save_merkle_state(["0x1", "0x2", "0x3"], "0x42")
    s.log_audit("0x1", recs[0]["wa_commitment"], "0x2", "sig")
    s.mark_withdrawn(recs[1]["id"], "tx")
    r = rstg.Store(path)
    assert [dataclasses.asdict(d) for d in r.all_deposits()] == [
        dataclasses.asdict(d) for d in wstg.Store(path).all_deposits()]
    assert r.get_deposit(recs[1]["id"]).status == "withdrawn"
    assert dataclasses.asdict(r.get_deposit(recs[2]["id"])) == recs[2]
    assert dataclasses.asdict(r.merkle_state()) == dataclasses.asdict(
        wstg.Store(path).merkle_state())
    assert r.audit_logs() == s.audit_logs()
    assert r.export_data() == s.export_data()


def _points():
    a = pr.g1_mul(3, G1GEN)
    c = pr.g1_mul(5, G1GEN)
    b2 = pr.g2_mul(7, pr.G2_GEN)
    cm = pr.g1_mul(11, G1GEN)
    pok = pr.g1_mul(13, G1GEN)
    return a, b2, c, cm, pok


def test_proof_hex_bundle(tmp_path):
    a, b2, c, cm, pok = _points()
    payload = ph.bundle((a, b2, c, cm, pok), b"\x00" * 172)
    assert len(bytes.fromhex(payload["withdraw"]["proof_hex"])) == 388
    p = str(tmp_path / "proof-hex.json")
    ph.save_bundle(p, payload)
    loaded = ph.load_bundle(p)
    pf = gf.parse_proof(bytes.fromhex(loaded["withdraw"]["proof_hex"]))
    assert pf.ar == a and pf.commitments == [cm]

    bad = dict(payload)
    bad["withdraw"] = {"proof_hex": "zz", "witness_hex": ""}
    ph.save_bundle(p, bad)
    with pytest.raises(ph.ShieldedPoolError):
        ph.load_bundle(p)


def test_address_table():
    addrs = {k: f"addr_{k}" for k in ph.AddressTable.STATIC_KEYS}
    alt = ph.AddressTable(addrs)
    names = ["vault", "pool_state", "recipient_slot"]
    packed = alt.compress(names)
    assert len(packed) == 3
    assert alt.expand(packed) == [addrs[n] for n in names]


def test_metrics_registry():
    m = metrics.Metrics()
    m.incr("x")
    m.incr("x", 2)
    with m.timer("t"):
        pass
    snap = m.snapshot()
    assert snap["counters"]["x"] == 3
    assert snap["timings"]["t"]["count"] == 1
    m.reset()
    assert m.snapshot() == {"counters": {}, "timings": {}}


def test_stage_timer_and_trace(tmp_path, monkeypatch):
    """``trace()`` writes nothing without TORCH_PROFILE_DIR, and a span
    outside a profile is the null context; with it, the Chrome trace
    carries the program's spans as user annotations, nested."""
    monkeypatch.delenv("TORCH_PROFILE_DIR", raising=False)
    with profiling.trace("off"):
        assert metrics.span("prove.proof") is metrics.NULL_SPAN
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("TORCH_PROFILE_DIR", str(tmp_path))
    with profiling.trace("on"):
        with metrics.span("prove.proof"):
            with metrics.span("prove.combine"):
                torch.ones(4).sum()
    assert metrics.span("prove.proof") is metrics.NULL_SPAN
    with open(tmp_path / "on.json") as f:
        events = json.load(f)["traceEvents"]
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    outer, inner = notes["prove.proof"], notes["prove.combine"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("with_commitment", [False, True])
def test_emit_proof_byte_equal_to_jax(with_commitment):
    a, b2, c, cm, pok = _points()
    args = (a, b2, c, [cm], pok) if with_commitment else (a, b2, c)
    raw = gf.emit_proof(*args)
    assert raw == jgf.emit_proof(*args)
    assert len(raw) == (388 if with_commitment else 260)
    assert dataclasses.astuple(gf.parse_proof(raw)) == dataclasses.astuple(
        jgf.parse_proof(raw))
    assert gf.emit_proof(None, None, None) == jgf.emit_proof(None, None, None)


def _g1b(p):
    return b"\x00" * 64 if p is None else (
        p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big"))


def _g2b(q):
    (a0, a1), (b0, b1) = q
    return b"".join(v.to_bytes(32, "big") for v in (a1, a0, b1, b0))


def _vk_bytes():
    """A gnark ``.vk`` layout assembled from pairing_ref points: three K
    points, one commitment over public index 1, one key pair."""
    g1 = [pr.g1_mul(k, G1GEN) for k in (2, 3, 5, 7, 11, 13, 17)]
    g2 = [pr.g2_mul(k, pr.G2_GEN) for k in (19, 23, 29, 31, 37)]
    out = (_g1b(g1[0]) + _g1b(g1[1]) + _g2b(g2[0]) + _g2b(g2[1])
           + _g1b(g1[2]) + _g2b(g2[2]) + struct.pack(">I", 3)
           + b"".join(_g1b(p) for p in g1[3:6]) + struct.pack(">I", 1)
           + struct.pack(">II", 1, 1) + struct.pack(">I", 1)
           + _g2b(g2[3]) + _g2b(g2[4]))
    return out


def _outcome(fn, raw):
    try:
        return ("ok", dataclasses.astuple(fn(raw)))
    except Exception as e:          # the failure's type, as JAX's
        return ("raised", type(e).__name__)


def test_parse_vk_and_public_witness_equal_jax():
    raw = _vk_bytes()
    got, want = gf.parse_vk(raw), jgf.parse_vk(raw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.public_committed == [[1]] and len(got.gamma_abc) == 3
    vals = [random.Random(4).getrandbits(254) for _ in range(5)]
    blob = struct.pack(">III", 5, 0, 5) + b"".join(
        v.to_bytes(32, "big") for v in vals)
    assert gf.parse_public_witness(blob) == jgf.parse_public_witness(
        blob) == vals
    with pytest.raises(ValueError, match="trailing"):   # JAX asserts
        gf.parse_vk(raw + b"\x00")
    with pytest.raises(AssertionError):
        jgf.parse_vk(raw + b"\x00")


def _port_refuses(parsed, raw):
    """Whether a value JAX's parser returned holds what the port's checks
    refuse: a coordinate not below p, a G2 point outside the order-r
    subgroup, or a proof's commitments read past the end of its bytes."""
    ints, g2s = [], []

    def walk(v):
        if isinstance(v, int):
            ints.append(v)
        elif isinstance(v, (tuple, list)):
            if len(v) == 2 and all(isinstance(c, tuple) and len(c) == 2
                                   and all(isinstance(w, int) for w in c)
                                   for c in v):
                g2s.append(v)
            for w in v:
                walk(w)

    walk(parsed)
    past_end = (len(parsed) == 5 and 260 + 64 * len(parsed[3]) > len(raw))
    return past_end or any(v >= FP_MOD for v in ints) or any(
        pr.g2_mul(FR_MOD, q) is not None for q in g2s
        if max(max(c) for c in q) < FP_MOD)


def test_malformed_bytes_fail_the_same_way():
    """Flipped bytes in a proof and a VK: where JAX parses, the port parses
    the same values or refuses with ``ValueError`` what its stricter checks
    refuse (a coordinate not below p, G2 outside its subgroup, points past
    the end); where JAX raises, the port raises too (``ValueError`` where
    JAX asserts)."""
    a, b2, c, cm, pok = _points()
    proof = gf.emit_proof(a, b2, c, [cm], pok)
    vk = _vk_bytes()
    rng = random.Random(7)
    for raw, fns in ((proof, (gf.parse_proof, jgf.parse_proof)),
                     (vk, (gf.parse_vk, jgf.parse_vk))):
        for pos in [5, 100, 200, 257, 300] + [
                rng.randrange(len(raw)) for _ in range(6)]:
            bad = bytearray(raw)
            bad[pos] ^= 1 << rng.randrange(8)
            got = _outcome(fns[0], bytes(bad))
            want = _outcome(fns[1], bytes(bad))
            if want[0] == "ok" and got[0] == "raised":
                assert got[1] == "ValueError", pos
                assert _port_refuses(want[1], bytes(bad)), pos
            elif want[0] == "raised":
                assert got in (want, ("raised", "ValueError")), pos
            else:
                assert got == want, pos


def _r1cs(mod):
    """out = x^3 + x + 5 with t x, t a committed public (4 rows)."""
    fr = FR_MOD
    return mod.R1CS(num_vars=7, num_public=3,
                    a_rows=[{3: 1}, {4: 1}, {}, {2: 1}],
                    b_rows=[{3: 1}, {3: 1}, {0: 1}, {3: 1}],
                    c_rows=[{4: 1}, {5: 1},
                            {1: 1, 5: -1 % fr, 3: -1 % fr, 0: -5 % fr},
                            {6: 1}])


def test_circuit_hash_equals_jax():
    r, jr = _r1cs(g16), _r1cs(jg16)
    for seed, committed in ((1337, ()), (7, (3,)), (1337, (3, 1))):
        assert cache.circuit_hash(r, seed, committed) == \
            jcache.circuit_hash(jr, seed, committed)
    assert cache.circuit_hash(r) != cache.circuit_hash(r, seed=1)


def test_cached_setup_round_trip(tmp_path):
    r = _r1cs(g16)
    d = str(tmp_path / "cache")
    pk, vk = cache.cached_setup(r, seed=5, cache_dir=d)
    files = os.listdir(d)
    assert files == [f"groth16_{cache.circuit_hash(r, 5)[:32]}.pkl"]
    pk2, vk2 = cache.cached_setup(r, seed=5, cache_dir=d)
    assert type(pk2) is g16.ProvingKey and type(vk2) is g16.VerifyingKey
    assert vars(vk2) == vars(vk)
    assert cache._DEFAULT_DIR.endswith("tpu_zkpool_torch_artifacts")
    # a corrupt file is regenerated
    with open(os.path.join(d, files[0]), "wb") as f:
        f.write(b"not a pickle")
    _, vk3 = cache.cached_setup(r, seed=5, cache_dir=d)
    assert vars(vk3) == vars(vk)


def test_config_defaults_equal_jax():
    c, j = cfg.Config().validate(), jcfg.Config().validate()
    assert dataclasses.asdict(c.rlwe) == dataclasses.asdict(j.rlwe)
    assert dataclasses.asdict(c.mesh) == dataclasses.asdict(j.mesh)
    assert (c.fr_mod, c.fp_mod) == (j.fr_mod, j.fp_mod)
    assert c.rlwe.delta == j.rlwe.delta == 655360
    # JAX's [kernel] table has no counterpart: nothing in the port reads it
    assert [f.name for f in dataclasses.fields(cfg.Config)] == [
        "rlwe", "mesh", "fr_mod", "fp_mod"]


def test_config_toml_equal_jax_and_tpu_keys_rejected(tmp_path):
    p = tmp_path / "cfg.toml"
    p.write_text("""
[rlwe]
noise_bound = 5

[mesh]
shape = [2, 4]
axis_names = ["dp", "tp"]
""")
    c, j = cfg.Config.from_toml(str(p)), jcfg.Config.from_toml(str(p))
    assert dataclasses.asdict(c.rlwe) == dataclasses.asdict(j.rlwe)
    assert c.mesh.shape == j.mesh.shape == (2, 4)
    assert c.mesh.axis_names == j.mesh.axis_names == ("dp", "tp")
    for key, val in (("msm_window_bits", "10"), ("msm_backend", '"xla"'),
                     ("msm_limb15", "false"), ("poseidon_tile_lanes", "2048"),
                     ("compile_cache", "false")):
        t = tmp_path / f"{key}.toml"
        t.write_text(f"[kernel]\n{key} = {val}\n")
        jcfg.Config.from_toml(str(t))             # a kernel knob in JAX
        with pytest.raises(AssertionError, match="unknown Config tables"):
            cfg.Config.from_toml(str(t))
    t = tmp_path / "unknown_key.toml"
    t.write_text("[rlwe]\nnoise = 5\n")
    with pytest.raises(AssertionError, match="unknown RlweConfig"):
        cfg.Config.from_toml(str(t))
    with pytest.raises(AssertionError):
        cfg.Config(rlwe=cfg.RlweConfig(n=1000)).validate()
    with pytest.raises(AssertionError):
        cfg.Config(rlwe=cfg.RlweConfig(q=167772160)).validate()
    old = cfg.get_config()
    try:
        cfg.load_config(str(p))
        assert cfg.get_config().rlwe.noise_bound == 5
        cfg.set_config(cfg.Config(rlwe=cfg.RlweConfig(noise_bound=2)))
        assert cfg.get_config().rlwe.noise_bound == 2
    finally:
        cfg.set_config(old)


def test_mesh_config_make(monkeypatch):
    mesh = cfg.MeshConfig(shape=(2, 2), axis_names=("dp", "sp")).make(
        device="cpu")
    assert mesh.size == 4 and mesh.shape == {"dp": 2, "sp": 2}
    assert {s.device.type for s in mesh.slots} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cfg.MeshConfig().make()
