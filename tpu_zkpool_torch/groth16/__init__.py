"""Groth16 on the port: the Fr NTT (``domain``), the device prover
(``prove``), the batched verify (``verify``), the native row evaluation and
witness VM (``solver_native``), the host circuit frontend (``builder``,
``gadgets``), the ACIR frontend (``acir``, ``solver``, ``r1cs``), gnark's
constraint systems (``ccs``, ``ccs_solve``), the gnark byte formats
(``gnark_fmt``) and the setup cache (``cache``)."""
