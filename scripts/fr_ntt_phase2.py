#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s checks of the H(X) kernels P4 and P5 alone on
one NVIDIA GPU: ``csrc/fr_ntt.cu`` built (``-Xptxas -v``), P4's passes and
P5 held to their plain versions in every mode (``check_fr_ntt``), both
timed beside the plain versions and the bound (``time_fr_ntt``), then the
prover's H(X) pipeline through them against its plain twin on the card at
domain 2^14 (with no host sync, its device kernels by ``torch.profiler``)
and, unless ``--check``, at 2^21 (the split pipeline) too
(``h_pipeline_check``). No proof runs, so no other kernel is built.

    python3 scripts/fr_ntt_phase2.py [--check] [--json PATH]

from a checkout's root.

It prints the card (``nvidia-smi`` name and power limit), the kernels'
ptxas lines, one line a check or timing, and exits non-zero if a check
fails; ``--json PATH`` also writes every result there.
"""

import json
import os
import sys
import time

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_zkpool_torch.groth16 import ntt_kernels as nkern  # noqa: E402


def main(argv):
    if not torch.cuda.is_available():
        print("fr_ntt_phase2: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    clock = cs.nvidia_smi("clocks.max.sm").split()[0:1]
    clock_hz = float(clock[0]) * 1e6 if clock else 1.98e9
    t0 = time.perf_counter()
    _, ptxas = nkern.build(["-Xptxas", "-v"])
    out = dict(build_s=time.perf_counter() - t0)
    for name, r in cs.ptxas_summary(ptxas or "").items():
        print(f"{name}: {json.dumps(r)}", flush=True)
    t0 = time.perf_counter()
    errs, pass_launches, want_launches = cs.check_fr_ntt(device)
    bad = {str(k): v for k, v in errs.items() if v}
    out.update(check_s=time.perf_counter() - t0, cases=len(errs),
               pass_launches=pass_launches, want_launches=want_launches,
               bad=bad)
    print(json.dumps(out), flush=True)
    ok = not bad and pass_launches == want_launches
    times = cs.time_fr_ntt(device, clock_hz)
    out["times"] = {k[0]: v for k, v in times.items()}
    for name, t in out["times"].items():
        for u in cs._timed(t):
            graph = (f", in a CUDA graph {u['graph_ms']:.5f} ms"
                     if "graph_ms" in u else "")
            print(f"{name} {u['shape']}: max |err| {u['max_abs_err']}, "
                  f"{u['ms']:.5f} ms{graph}, plain {u['plain_ms']:.3f} ms, "
                  f"bound {u['bound_ms']:.5f} ms ({u['bound_by']})",
                  flush=True)
            ok &= u["max_abs_err"] == 0
    sizes = [cs.FR_ROW] + ([] if "--check" in argv else [cs.FR_BIG])
    for log_n in sizes:
        r = cs.h_pipeline_check(device, 1 << log_n, profile=log_n < 20)
        out[f"pipeline_2^{log_n}"] = r
        print(f"pipeline 2^{log_n}: " + json.dumps(r), flush=True)
        ok &= r["equal"] and r["sync_free"] and r.get("only_p4_p5", True)
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(out, f, indent=1, default=str)
    print(json.dumps(dict(ok=bool(ok), card=cs.nvidia_smi(
        "name,power.limit"))), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
