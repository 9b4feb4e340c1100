"""Port parity: the pool's state machine and flows
(``tpu_zkpool_torch.protocol``) against ``tpu_zkpool.protocol``.

Every case of ``tests/test_protocol.py`` runs on the port over a
``MerkleTree(device="cpu")`` (its levels through K7's plain twin), and the
flows' blobs equal JAX's byte for byte. The JAX functions that read a tree
get a stand-in whose ``get_root`` and ``get_proof`` answer from fixed lists,
so no JAX tree is ever built. The committed withdraw vector
(``tests/vectors.py``) is rebuilt end to end on the port's tree. The wire
format's input checks (``groth16/gnark_fmt.py``), the verify's public-input
count and the app's withdraw header are held to their refusals, and valid
proofs and VKs to JAX's parser.
"""

import dataclasses
import random
import struct
import tracemalloc
import types

import pytest
import torch

from tpu_zkpool.groth16 import gnark_fmt as jgf
from tpu_zkpool.protocol import flows as jflows
from tpu_zkpool.protocol import state as jst

from tpu_zkpool_torch.fields.bn254 import FP_MOD, FR_MOD, G1_GX, G1_GY
from tpu_zkpool_torch.groth16 import gnark_fmt as gf
from tpu_zkpool_torch.groth16 import verify as tv
from tpu_zkpool_torch.merkle import MerkleTree
from tpu_zkpool_torch.protocol import flows
from tpu_zkpool_torch.protocol import state as st
from tpu_zkpool_torch.protocol.relayer import Relayer
from tpu_zkpool_torch.protocol.state import Pool, PoolError
from tpu_zkpool_torch.refimpl import pairing_ref as pr
from tpu_zkpool_torch.webui.app import WithdrawCircuit

import vectors


class FixedTree:
    """A stand-in tree: ``get_root`` and ``get_proof`` from fixed lists."""

    def __init__(self, root, siblings):
        self.root, self.siblings = root, list(siblings)

    def get_root(self):
        return self.root

    def get_proof(self, index):
        return list(self.siblings)


def make_pool(accept=True):
    ok = lambda proof, wit: accept and proof != b"\x00" * st.PROOF_LEN
    pool = Pool(withdraw_verifier=ok, audit_verifier=ok)
    pool.initialize()
    return pool


def test_state_bytes_roundtrip():
    s = st.ShieldedPoolState()
    js = jst.ShieldedPoolState()
    for r in range(1, 40):
        s.add_root(r * 1000)
        js.add_root(r * 1000)
    raw = s.to_bytes()
    assert len(raw) == 1072 and raw == js.to_bytes()  # state.rs layout
    s2 = st.ShieldedPoolState.from_bytes(raw)
    assert s2.current_root == s.current_root
    assert s2.root_history == s.root_history
    # ring window: root 7000 was evicted (39 inserts > 32 window)
    assert not s2.check_root(7 * 1000)
    assert s2.check_root(39 * 1000)
    assert s2.root_age(39 * 1000) == 0
    assert [s2.root_age(r * 1000) for r in range(1, 40)] == [
        js.root_age(r * 1000) for r in range(1, 40)]


def test_audit_record_bytes():
    rec = st.AuditRecord(wa_commitment=0x1234)
    raw = rec.to_bytes()
    assert len(raw) == 40 and raw == jst.AuditRecord(0x1234).to_bytes()
    assert st.AuditRecord.from_bytes(raw).wa_commitment == 0x1234


def test_full_flow_and_negatives():
    pool = make_pool()
    tree = MerkleTree(device="cpu")
    ident = flows.Identity.generate(12345)
    note = flows.Note(ident, amount=1_000_000, randomness=67890)
    idx = tree.insert(note.commitment)
    payer = pool.deposit(10_000_000, note.amount, note.commitment,
                         tree.get_root())
    assert payer == 9_000_000

    recipient = bytes(range(32))
    w = flows.build_withdraw_witness(tree, note, idx, recipient, note.amount)
    proof = b"\x01" * st.PROOF_LEN
    audit_wit = flows.audit_witness_blob(ident.wa_commitment, 999)
    pool.submit_audit(proof, audit_wit)

    rec, amt = pool.withdraw(proof, w.witness_blob())
    assert amt == note.amount
    assert rec == st.encode_recipient(recipient)

    # double spend: same nullifier
    with pytest.raises(PoolError, match="nullifier"):
        pool.withdraw(proof, w.witness_blob())

    # corrupted proof
    note2 = flows.Note(ident, amount=500_000, randomness=1)
    idx2 = tree.insert(note2.commitment)
    pool.deposit(10_000_000, note2.amount, note2.commitment, tree.get_root())
    w2 = flows.build_withdraw_witness(tree, note2, idx2, recipient,
                                      note2.amount)
    with pytest.raises(PoolError, match="proof verification"):
        pool.withdraw(b"\x00" * st.PROOF_LEN, w2.witness_blob())

    # bad recipient encoding
    blob = bytearray(w2.witness_blob())
    blob[76] = 0xFF
    with pytest.raises(PoolError, match="recipient"):
        pool.withdraw(proof, bytes(blob))

    # unknown root
    blob = bytearray(w2.witness_blob())
    blob[12:44] = (123456789).to_bytes(32, "big")
    with pytest.raises(PoolError, match="root"):
        pool.withdraw(proof, bytes(blob))

    # missing audit record
    other = flows.Identity.generate(777)
    note3 = flows.Note(other, amount=500_000, randomness=2)
    idx3 = tree.insert(note3.commitment)
    pool.deposit(10_000_000, note3.amount, note3.commitment, tree.get_root())
    w3 = flows.build_withdraw_witness(tree, note3, idx3, recipient,
                                      note3.amount)
    with pytest.raises(PoolError, match="audit record"):
        pool.withdraw(proof, w3.witness_blob())
    # every sibling path read from the tree's levels checks out
    for wi, n in ((w, note), (w2, note2), (w3, note3)):
        assert MerkleTree.verify_proof(n.commitment, wi.index, wi.siblings,
                                       wi.root)


def test_relayer_payroll_three_recipients():
    pool = make_pool()
    relayer = Relayer(pool)
    tree = MerkleTree(device="cpu")
    proof = b"\x01" * st.PROOF_LEN

    results = []
    for i in range(3):
        ident = flows.Identity.generate(1000 + i)
        note = flows.Note(ident, amount=2_000_000, randomness=i + 1)
        idx = tree.insert(note.commitment)
        pool.deposit(10_000_000, note.amount, note.commitment, tree.get_root())
        recipient = bytes([i]) * 32
        w = flows.build_withdraw_witness(tree, note, idx, recipient,
                                         note.amount)
        audit_wit = flows.audit_witness_blob(ident.wa_commitment, i)
        res = relayer.relay_withdraw(proof, w.witness_blob(), proof, audit_wit)
        results.append(res)
    assert [r.amount for r in results] == [2_000_000] * 3
    assert len({r.recipient for r in results}) == 3
    # repeat audit is idempotent, repeat withdraw double-spends
    with pytest.raises(PoolError, match="nullifier"):
        relayer.relay_withdraw(proof, w.witness_blob(), proof, audit_wit)
    assert relayer.status()["low_balance"] is False
    assert relayer.status()["metrics"]["counters"][
        "relayer.withdrawals"] >= 3


def test_idempotent_initialize_and_audit():
    pool = make_pool()
    s0 = pool.state
    pool.initialize()
    assert pool.state is s0
    proof = b"\x01" * st.PROOF_LEN
    wit = flows.audit_witness_blob(42, 43)
    assert pool.submit_audit(proof, wit) == 42
    # second submission: no verifier call needed (idempotent)
    pool.audit_verifier = lambda *a: (_ for _ in ()).throw(AssertionError)
    assert pool.submit_audit(proof, wit) == 42


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_flows_byte_equal_to_jax(seed):
    """Identity keygen, the note's commitment and nullifier, the deposit
    instruction, the audit blob, and a withdraw witness from the same
    fields (the JAX one over a stand-in tree answering the port's path)."""
    rng = random.Random(seed)
    sk = rng.getrandbits(128)
    ident, jident = flows.Identity.generate(sk), jflows.Identity.generate(sk)
    assert (ident.secret_key, ident.owner_x, ident.owner_y) == (
        jident.secret_key, jident.owner_x, jident.owner_y)
    assert ident.wa_commitment == jident.wa_commitment
    amount, rand = rng.randrange(1, 1 << 40), rng.getrandbits(200)
    note = flows.Note(ident, amount=amount, randomness=rand)
    jnote = jflows.Note(jident, amount=amount, randomness=rand)
    assert note.commitment == jnote.commitment
    assert note.nullifier(seed) == jnote.nullifier(seed)
    root = rng.getrandbits(250)
    assert flows.deposit_instruction(amount, note.commitment, root) == \
        jflows.deposit_instruction(amount, jnote.commitment, root)
    wa, ct = rng.getrandbits(256), rng.getrandbits(256)
    assert flows.audit_witness_blob(wa, ct) == jflows.audit_witness_blob(
        wa, ct)
    siblings = [rng.getrandbits(250) for _ in range(16)]
    recipient = bytes(rng.getrandbits(8) for _ in range(32))
    w = flows.build_withdraw_witness(FixedTree(root, siblings), note, seed,
                                     recipient, amount)
    jw = jflows.build_withdraw_witness(FixedTree(root, siblings), jnote,
                                       seed, recipient, amount)
    assert w.witness_blob() == jw.witness_blob()
    assert w.acir_inputs() == jw.acir_inputs()
    assert vars(w) == vars(jw)
    built = flows.WithdrawWitness(**vars(jw))
    assert built.witness_blob() == jw.witness_blob()


def test_committed_withdraw_vector_on_the_port_tree():
    """``client/prover-params.toml``: the note at leaf 0 of an empty tree
    on the port gives the committed root, nullifier, wa commitment,
    recipient field and sibling path."""
    ident = flows.Identity.generate(vectors.SECRET_KEY)
    assert (ident.owner_x, ident.owner_y) == (vectors.OWNER_X,
                                              vectors.OWNER_Y)
    note = flows.Note(ident, amount=vectors.AMOUNT,
                      randomness=vectors.RANDOMNESS)
    tree = MerkleTree(device="cpu")
    assert tree.insert(note.commitment) == vectors.INDEX
    recipient = vectors.RECIPIENT.to_bytes(32, "big")[2:] + b"\x00\x00"
    w = flows.build_withdraw_witness(tree, note, 0, recipient,
                                     vectors.AMOUNT)
    assert w.public_inputs() == [vectors.ROOT, vectors.NULLIFIER,
                                 vectors.RECIPIENT, vectors.AMOUNT,
                                 vectors.WA_COMMITMENT]
    assert w.siblings == vectors.SIBLINGS
    assert w.acir_inputs() == vectors.withdraw_inputs()


# ------------------------------------------ the wire format's input checks

G1GEN = (G1_GX, G1_GY)


def _proof_points():
    return (pr.g1_mul(3, G1GEN), pr.g2_mul(7, pr.G2_GEN),
            pr.g1_mul(5, G1GEN))


@pytest.mark.parametrize("case,match", [
    ("a_x_plus_p", "not below p"), ("b_outside_subgroup", "subgroup"),
    ("a_off_curve", "not on G1")])
def test_parse_proof_rejects_bad_points(case, match):
    """Each bad point raises ValueError. JAX's parser takes the first two
    (it checks neither the range nor the subgroup) and asserts on the
    third."""
    a, b2, c = _proof_points()
    raw = bytearray(gf.emit_proof(a, b2, c))
    if case == "a_x_plus_p":
        raw[0:32] = (a[0] + FP_MOD).to_bytes(32, "big")
    elif case == "b_outside_subgroup":
        raw = bytearray(gf.emit_proof(a, pr.twist_point_outside_g2(16), c))
    else:
        raw[32:64] = ((a[1] + 1) % FP_MOD).to_bytes(32, "big")
    with pytest.raises(ValueError, match=match):
        gf.parse_proof(bytes(raw))
    if case == "a_off_curve":
        with pytest.raises(AssertionError):
            jgf.parse_proof(bytes(raw))
    else:
        assert jgf.parse_proof(bytes(raw)).krs == c


def _g1b(p):
    return p[0].to_bytes(32, "big") + p[1].to_bytes(32, "big")


def _g2b(q):
    (a0, a1), (b0, b1) = q
    return b"".join(v.to_bytes(32, "big") for v in (a1, a0, b1, b0))


def test_valid_proofs_and_vks_parse_as_jax():
    a, b2, c = _proof_points()
    cm, pok = pr.g1_mul(11, G1GEN), pr.g1_mul(13, G1GEN)
    for raw in (gf.emit_proof(a, b2, c), gf.emit_proof(a, b2, c, [cm], pok),
                gf.emit_proof(None, b2, c)):
        assert dataclasses.astuple(gf.parse_proof(raw)) == \
            dataclasses.astuple(jgf.parse_proof(raw))
    g1 = [pr.g1_mul(k, G1GEN) for k in (2, 3, 5, 7, 11)]
    g2 = [pr.g2_mul(k, pr.G2_GEN) for k in (19, 23, 29, 31, 37)]
    vk = (_g1b(g1[0]) + _g1b(g1[1]) + _g2b(g2[0]) + _g2b(g2[1])
          + _g1b(g1[2]) + _g2b(g2[2]) + struct.pack(">I", 2)
          + _g1b(g1[3]) + _g1b(g1[4]) + struct.pack(">I", 1)
          + struct.pack(">II", 1, 1) + struct.pack(">I", 1)
          + _g2b(g2[3]) + _g2b(g2[4]))
    got = gf.parse_vk(vk)
    assert dataclasses.astuple(got) == dataclasses.astuple(jgf.parse_vk(vk))
    assert got.beta_g2 == g2[0] and got.commitment_keys == [(g2[3], g2[4])]


@pytest.mark.parametrize("header,n_vals,ok", [
    ((5, 0, 5), 5, True), ((5, 1, 5), 5, False), ((4, 0, 5), 5, False),
    ((5, 0, 5), 4, False)])
def test_parse_public_witness_checks_its_header(header, n_vals, ok):
    vals = [random.Random(9).getrandbits(254) for _ in range(n_vals)]
    blob = struct.pack(">III", *header) + b"".join(
        v.to_bytes(32, "big") for v in vals)
    if ok:
        assert gf.parse_public_witness(blob) == jgf.parse_public_witness(
            blob) == vals
    else:
        with pytest.raises(ValueError, match="public witness"):
            gf.parse_public_witness(blob)


def test_verify_batch_refuses_wrong_public_counts():
    """A VK of two public inputs: one list short, one long, and a list
    count that differs from the proofs' are refused before any pairing; a
    committed proof's derived input counts as one."""
    vk = types.SimpleNamespace(gamma_abc=[G1GEN] * 3)
    proof = _proof_points()
    for pubs in ([[1]], [[1, 2, 3]], [[1, 2], [1, 2]]):
        with pytest.raises(ValueError, match="public"):
            tv.verify_batch(vk, [proof], pubs, device="cpu")
    cm, pok = pr.g1_mul(11, G1GEN), pr.g1_mul(13, G1GEN)
    tv.check_public_counts(vk, [proof, proof + (cm, pok)], [[1, 2], [1]])
    with pytest.raises(ValueError, match="proof 1: 3 public inputs"):
        tv.check_public_counts(vk, [proof + (cm, pok)] * 2, [[1], [1, 2]])


@pytest.mark.parametrize("header", [(2**32 - 1, 0, 5), (4, 0, 4),
                                    (5, 1, 5), (5, 0, 2**32 - 1)])
def test_withdraw_verifier_refuses_other_headers(header):
    """The app's withdraw verifier wants the (5, 0, 5) header: any other
    is False before anything is allocated or verified."""
    a, b2, c = _proof_points()
    blob = struct.pack(">III", *header) + bytes(32 * 5)
    stub = types.SimpleNamespace(vk=None, device=torch.device("cpu"))
    tracemalloc.start()
    try:
        assert WithdrawCircuit.verify(stub, gf.emit_proof(a, b2, c),
                                      blob) is False
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20
