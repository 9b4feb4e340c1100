"""The reference side of the audit configuration: the circuit built again
by the frozen builder (``zkbench.ref.audit_circuit``) in the configuration's
variant, each deposit's witness made from the same inputs, and the
judgement of the service's proofs: each must be the proof its deposit's
witness gives under the configuration's keys and the proof's blinding
(``groth16.Judge``).

The circuit's columns at tau (``Judge.columns``: a pass over all 1.19 M
rows) depend only on the circuit and the setup's seed, so the first run of
a checkout works them out and keeps them in the cache directory; later
runs read them, and each deposit's U(tau), V(tau), W(tau) are three inner
products with its witness. The rows stay the builder's: a var-PK circuit's
do not depend on the auditor key (the key is a witness), any other
variant's columns are kept under a digest of its key."""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import sys
import time

from zkbench.ref.audit_circuit import build_audit_circuit
from zkbench.ref.groth16 import R1CS, Judge, blinding


def _columns_path(cfg: dict, key, r1cs: R1CS, cache_dir: str) -> str:
    tag = ""
    if not cfg["variant"].startswith("var_pk"):
        tag = "_" + hashlib.sha256(repr(key).encode()).hexdigest()[:16]
    return os.path.join(
        cache_dir, "ref", f"audit_{cfg['variant']}_{cfg['setup_seed']}_"
        f"{len(r1cs.a_rows)}_{r1cs.num_vars}{tag}.pkl")


def _judge(cfg: dict, key, r1cs: R1CS, cache_dir) -> Judge:
    """The circuit's ``Judge``, its columns from the cache where there."""
    path = cache_dir and _columns_path(cfg, key, r1cs, cache_dir)
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return Judge(r1cs, cfg["setup_seed"], columns=pickle.load(f))
    j = Judge(r1cs, cfg["setup_seed"])
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(j.cols, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)
    return j


def judge(cfg: dict, requests: list, answers: list,
          cache_dir: str | None = None) -> dict:
    clock = time.perf_counter
    t0 = clock()
    a0, b0 = requests[0]["key"]
    circ = build_audit_circuit(a0, b0, variant=cfg["variant"])
    b = circ.builder
    r1cs = R1CS(b.num_vars, b.num_public, b.a_rows, b.b_rows, b.c_rows)
    t1 = clock()
    j = _judge(cfg, (a0, b0), r1cs, cache_dir)
    t2 = clock()
    evals = {}
    for d in sorted({ans["request"] for ans in answers}):
        dep = requests[d]
        c = dataclasses.replace(circ, pk_values=(tuple(dep["key"][0]),
                                                 tuple(dep["key"][1])))
        w = b.witness(c.assignment(dep["owner_x"], dep["owner_y"],
                                   dep["enc"], dep["wa"], dep["ct"],
                                   dep["sk"]))
        evals[d] = (w, j.at_tau(w))
    t3 = clock()
    proofs_wrong = 0
    for ans in answers:
        w, uvw = evals[ans["request"]]
        r, s = blinding(ans["blind"])
        if uvw is None or tuple(ans["proof"]) != j.expected(w, r, s, uvw):
            proofs_wrong += 1
    print(f"[zkbench] audit reference: circuit {t1 - t0:.3f} s, columns "
          f"{t2 - t1:.3f} s, {len(evals)} witnesses {t3 - t2:.3f} s, "
          f"{len(answers)} proofs {clock() - t3:.3f} s",
          file=sys.stderr, flush=True)
    return {"proofs_wrong": proofs_wrong}
