"""Port parity: the pool's state machine and flows
(``tpu_zkpool_torch.protocol``) against ``tpu_zkpool.protocol``.

Every case of ``tests/test_protocol.py`` runs on the port over a
``MerkleTree(device="cpu")`` (its levels through K7's plain twin), and the
flows' blobs equal JAX's byte for byte. The JAX functions that read a tree
get a stand-in whose ``get_root`` and ``get_proof`` answer from fixed lists,
so no JAX tree is ever built. The committed withdraw vector
(``tests/vectors.py``) is rebuilt end to end on the port's tree.
"""

import random

import pytest

from tpu_zkpool.protocol import flows as jflows
from tpu_zkpool.protocol import state as jst

from tpu_zkpool_torch.merkle import MerkleTree
from tpu_zkpool_torch.protocol import flows
from tpu_zkpool_torch.protocol import state as st
from tpu_zkpool_torch.protocol.relayer import Relayer
from tpu_zkpool_torch.protocol.state import Pool, PoolError

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
