"""Shielded-pool protocol layer (host code).

- ``audit_circuit``: the RLWE audit circuit built directly as R1CS, the
  port's copy of ``tpu_zkpool/protocol/audit_circuit.py``.
"""
