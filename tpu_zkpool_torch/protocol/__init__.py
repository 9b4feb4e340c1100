"""Shielded-pool protocol layer (host code), the port's copies of
``tpu_zkpool/protocol/``:

- ``state``: pool account state (root ring buffer, nullifier set, audit
  records, vault) and instruction byte formats; ``errors``: typed errors
  with recovery hints.
- ``flows``: deposit / withdraw / submit-audit flows and witness assembly,
  over the port's ``MerkleTree``; ``storage``: the client's JSON store.
- ``relayer``: the audit-then-withdraw batch relay; ``proof_hex``: proof
  and witness hex bundles, the address table.
- ``audit_circuit``: the RLWE audit circuit built directly as R1CS.
"""
