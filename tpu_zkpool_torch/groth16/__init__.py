"""Groth16 device prover: the Fr NTT (``domain``) and ``prove``."""
