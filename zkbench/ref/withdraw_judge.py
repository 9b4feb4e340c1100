"""The reference side of the withdraw configuration: its R1CS converted
from the same ACIR ``Program`` the benchmark writes (the frozen
``withdraw_acir`` and ``r1cs``), and the judgement of a relayer's proofs.

An answer holds the program's proof and the witness its solve produced.
The witness is judged by what it says: every row holds, its public inputs
are the request's. The proof must then be the one that witness gives under
the configuration's keys and the proof's blinding (``groth16.Judge``)."""

from __future__ import annotations

from zkbench.ref import r1cs as ref_r1cs
from zkbench.ref import withdraw_acir
from zkbench.ref.groth16 import R1CS, Judge, blinding


def reference(cfg: dict) -> Judge:
    ar = ref_r1cs.convert(withdraw_acir.withdraw_program(cfg["depth"]).program)
    r = ar.r1cs
    return Judge(R1CS(r.num_vars, r.num_public, r.a_rows, r.b_rows,
                      r.c_rows), cfg["setup_seed"])


def judge(cfg: dict, requests: list, answers: list,
          cache_dir: str | None = None) -> dict:
    """{number: value} over ``answers`` (dicts with ``request``, the index
    into ``requests``, ``blind``, ``proof`` and ``witness``). The circuit
    is small: nothing is cached."""
    j = reference(cfg)
    rows_failed = publics_wrong = proofs_wrong = 0
    for ans in answers:
        w = ans["witness"]
        req = requests[ans["request"]]
        u, v, x, bad = j.evaluate(w)
        rows_failed += bad
        if list(w[1:6]) != [req[i] for i in range(5)]:
            publics_wrong += 1
        r, s = blinding(ans["blind"])
        if tuple(ans["proof"]) != j.expected(w, r, s, (u, v, x)):
            proofs_wrong += 1
    return {"proofs_wrong": proofs_wrong, "publics_wrong": publics_wrong,
            "witness_rows_failed": rows_failed}
