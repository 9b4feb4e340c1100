#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 11 alone on one NVIDIA GPU: the Poseidon2
kernel P3 built (``-Xptxas -v``) with the kernels the audit proof needs,
held to its plain version in both forms (``check_poseidon2``), the
product forms' times (a dependent product or level: one thread, three on
three lanes, one split over 4 and over 8 lanes, the last P3's), the need
for P3 and P3 alone timed (``time_poseidon2``), then, unless ``--check``,
the audit path of ``phase_audit`` (keygen, Shamir, 256 encryptions with
their quotient witnesses, ``ct_commitment`` through P3, the committed audit
proof proved and verified, the auditor's decrypt).

    python3 scripts/audit_phase11.py [--check]      # from a checkout's root

It prints the card (``nvidia-smi`` name and power limit), the kernels'
ptxas lines and one JSON line, and exits non-zero if a check fails.
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_zkpool_torch import cuda_build, native_bridge  # noqa: E402
from tpu_zkpool_torch.curve import pairing_kernels as pkern  # noqa: E402
from tpu_zkpool_torch.groth16 import solver_native  # noqa: E402
from tpu_zkpool_torch.hash import kernels as hkern  # noqa: E402
from tpu_zkpool_torch.hash import poseidon2_kernels as p2k  # noqa: E402
from tpu_zkpool_torch.msm import kernels  # noqa: E402


def main(argv):
    if not torch.cuda.is_available():
        print("audit_phase11: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    clock = cs.nvidia_smi("clocks.max.sm").split()[0:1]
    clock_hz = float(clock[0]) * 1e6 if clock else 1.98e9
    check_only = "--check" in argv
    t0 = time.perf_counter()
    cus = [p2k.SOURCE, "mul_bench.cu"] + ([] if check_only else [
        kernels.SOURCE, hkern.SOURCE, pkern.SOURCE])
    with ThreadPoolExecutor(len(cus) + 2) as ex:
        futs = [ex.submit(cuda_build.build, cu, ["-Xptxas", "-v"])
                for cu in cus]
        host = [ex.submit(native_bridge.get_lib),
                ex.submit(solver_native.get_lib)]
        built = [f.result() for f in futs]
        for f in host:
            f.result()
    ptxas = "".join(b[1] or "" for b in built)
    for name, r in cs.ptxas_summary(ptxas).items():
        if name.startswith("k_poseidon2"):
            print(f"{name}: {json.dumps(r)}", flush=True)
    out = dict(build_s=time.perf_counter() - t0)
    products = cs.time_products(device)
    t0 = time.perf_counter()
    sponge = {}
    errs, perm_ms = cs.check_poseidon2(device, keep=sponge)
    out.update(check_s=time.perf_counter() - t0, modes=len(errs),
               errs={f"{k[1]} {k[2]}": v for k, v in errs.items()},
               plain_permutation_ms=perm_ms,
               level_us={r["form"]: r["us_step"]
                         for (ncomp, form), r in products.items()
                         if ncomp == 1 and form in (0, 2, cs.K6_FORM,
                                                    *cs.LANE_FORMS)})
    print(json.dumps(out, default=str), flush=True)
    ok = not any(errs.values()) and not any(
        r["max_abs_err"] for r in products.values())
    out["p3"] = cs.time_poseidon2(device, clock_hz, products, sponge)
    ok &= out["p3"]["max_abs_err"] == 0
    print(json.dumps(out["p3"], default=str), flush=True)
    if not check_only:
        out["audit"] = cs.phase_audit(device)
        ok &= out["audit"]["ok"]
        print(json.dumps(out["audit"], default=str), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
