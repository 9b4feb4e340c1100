"""Pure-Python (bigint) host code copied from ``tpu_zkpool.refimpl``:
pairing, Pedersen commitments, Groth16 setup/verify and the RLWE ring's
schoolbook product."""
