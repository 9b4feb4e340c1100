"""The compliance service's audit prover, through the port: the circuit of
``protocol.audit_circuit.build_audit_circuit`` in the configuration's
variant, its keys from ``groth16.cache.cached_setup``, on the device in a
``DeviceProvingKey``; each deposit's witness (``CircuitBuilder.witness``
of the circuit's assignment under the deposit's auditor key) made in
set-up; a request proved by ``groth16.prove.prove``."""

from __future__ import annotations

import dataclasses
import os


class System:
    def __init__(self, cfg: dict, device, cache_dir: str, requests: list):
        from tpu_zkpool_torch.groth16 import prove
        from tpu_zkpool_torch.groth16.cache import cached_setup
        from tpu_zkpool_torch.protocol.audit_circuit import build_audit_circuit
        self._prove = prove
        a0, b0 = requests[0]["key"]
        circ = build_audit_circuit(a0, b0, variant=cfg["variant"])
        self.r1cs = circ.builder.r1cs()
        pk, _ = cached_setup(self.r1cs, seed=cfg["setup_seed"],
                             cache_dir=os.path.join(cache_dir, "keys"))
        m = cfg["msm"]
        self.dpk = prove.DeviceProvingKey(pk, c=m["c"], lanes=m["lanes"],
                                          complete=m["complete"],
                                          tree=m["tree"], device=device)
        self.witnesses = []
        for d in requests:
            c = dataclasses.replace(circ, pk_values=(tuple(d["key"][0]),
                                                     tuple(d["key"][1])))
            self.witnesses.append(circ.builder.witness(c.assignment(
                d["owner_x"], d["owner_y"], d["enc"], d["wa"], d["ct"],
                d["sk"])))
        self.msm_points = {"g1": [len(pk.a_query), len(pk.b1_query),
                                  len(pk.k_query), len(pk.h_query)],
                           "g2": [len(pk.b2_query)]}

    def serve(self, indices: list, blind_seed: int, rec=None) -> list:
        """Prove the deposits ``indices`` one after another; proof i takes
        the blinding seed ``blind_seed + i``. ``rec``, if given, collects
        each proof's phases (``prove(timings=)``: the device synchronised
        around each)."""
        out = []
        for i, d in enumerate(indices):
            t = {} if rec is not None else None
            p = self._prove.prove(self.dpk, self.r1cs, self.witnesses[d],
                                  seed=blind_seed + i, timings=t)
            if rec is not None:
                rec.timing(t)
            out.append({"proof": p})
        return out
