"""Groth16 on the port: the Fr NTT (``domain``), the device prover
(``prove``), the batched verify (``verify``), the native row evaluation
(``solver_native``), the host circuit frontend (``builder``,
``gadgets``), the gnark byte formats (``gnark_fmt``) and the setup cache
(``cache``)."""
