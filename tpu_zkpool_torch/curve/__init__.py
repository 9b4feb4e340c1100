"""BN254 pairing for the batched Groth16 verify: the Fp2 / Fp12 tower
(``tower``), the host walk of the Miller-loop lines (``lines``), the device
Miller loop and final exponentiation (``pairing``, kernels P1 and P2 in
``pairing_kernels``)."""
