"""Pure-Python (bigint) host code copied from ``tpu_zkpool.refimpl``:
pairing, Pedersen commitments and Groth16 setup/verify."""
