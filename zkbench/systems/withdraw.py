"""The withdraw prover of a relayer, through the port's normal path (as
``webui.app.WithdrawCircuit`` runs it): the ACIR artifact parsed by
``groth16.acir``, converted by ``groth16.r1cs.convert``, its keys from
``groth16.cache.cached_setup`` and on the device in a ``DeviceProvingKey``;
a request solved by ``groth16.solver_native.solve`` and
``groth16.r1cs.build_witness``, a batch proved by
``groth16.prove.prove_batch``."""

from __future__ import annotations

import os
import time

from zkbench.ref import withdraw_acir


class System:
    def __init__(self, cfg: dict, device, cache_dir: str, requests: list):
        self.requests = requests
        from tpu_zkpool_torch.groth16 import acir, prove, r1cs, solver_native
        from tpu_zkpool_torch.groth16.cache import cached_setup
        self._prove, self._r1cs, self._solver = prove, r1cs, solver_native
        path = os.path.join(cache_dir, f"withdraw_d{cfg['depth']}.json")
        wp = withdraw_acir.withdraw_program(cfg["depth"])
        withdraw_acir.write_artifact(path, wp.program, wp.abi)
        _, self.program = acir.load_artifact(path)
        self.ar = r1cs.convert(self.program)
        pk, _ = cached_setup(self.ar.r1cs, seed=cfg["setup_seed"],
                             cache_dir=os.path.join(cache_dir, "keys"))
        m = cfg["msm"]
        self.dpk = prove.DeviceProvingKey(pk, c=m["c"], lanes=m["lanes"],
                                          complete=m["complete"],
                                          tree=m["tree"], device=device)
        self.msm_points = {"g1": [len(pk.a_query), len(pk.b1_query),
                                  len(pk.k_query), len(pk.h_query)],
                           "g2": [len(pk.b2_query)]}

    def serve(self, indices: list, blind_seed: int, rec=None) -> list:
        """Solve the requests ``indices`` and prove them as one batch; proof
        i takes the blinding seed ``blind_seed + i``. ``rec``, if given,
        collects the seconds of each solve (``solve`` and
        ``build_witness``) as the span ``solve``."""
        clock = time.perf_counter
        ws = []
        for i in indices:
            req = self.requests[i]
            t0 = clock()
            w = self._r1cs.build_witness(self.ar,
                                         self._solver.solve(self.program, req))
            if rec is not None:
                rec.span("solve", clock() - t0)
            ws.append(w)
        proofs = self._prove.prove_batch(self.dpk, self.ar.r1cs, ws,
                                         seed=blind_seed)
        return [{"proof": p, "witness": w} for p, w in zip(proofs, ws)]
