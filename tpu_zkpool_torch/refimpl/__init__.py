"""Pure-Python (bigint) host code copied from ``tpu_zkpool.refimpl``:
pairing, Pedersen commitments, Groth16 setup/verify, the embedded curve,
and RLWE with Shamir sharing (the audit path's oracles)."""
