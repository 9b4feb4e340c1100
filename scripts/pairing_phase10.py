#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 10 alone on one NVIDIA GPU: the pairing
kernels P1 and P2 built (``-Xptxas -v``), held to their plain versions
(``check_pairing``) and timed at the verify's batch of 256
(``time_pairing``), after the lane programs' first compile and upload
(``time_programs``); then, unless ``--check``, the batched Groth16 verify
of ``phase_verify`` on phase 4's withdraw-shape key (cold and warm, each
with its host/device split).

    python3 scripts/pairing_phase10.py [--check]     # from a checkout's root

Run from two checkouts in one call, it compares them on one card. It
prints the card (``nvidia-smi`` name and power limit), the kernels' ptxas
lines and one JSON line, and exits non-zero if a check fails.
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
from tpu_zkpool_torch.groth16 import prove as tp  # noqa: E402
from tpu_zkpool_torch.groth16 import solver_native  # noqa: E402
from tpu_zkpool_torch.msm import kernels  # noqa: E402
from tpu_zkpool_torch.refimpl.groth16_ref import setup  # noqa: E402


def main(argv):
    if not torch.cuda.is_available():
        print("pairing_phase10: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    clock = cs.nvidia_smi("clocks.max.sm").split()[0:1]
    clock_hz = float(clock[0]) * 1e6 if clock else 1.98e9
    check_only = "--check" in argv
    t0 = time.perf_counter()
    cus = [pkern.SOURCE, "mul_bench.cu"] + ([] if check_only
                                             else [kernels.SOURCE])
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
        print(f"{name}: {json.dumps(r)}", flush=True)
    out = dict(build_s=time.perf_counter() - t0)
    products = cs.time_products(device)
    inverses = cs.time_inverses(device)
    out["programs_s"] = cs.time_programs(device)
    t0 = time.perf_counter()
    errs, plain_ms, (g3, l3) = cs.check_pairing(device)
    out.update(check_s=time.perf_counter() - t0, modes=len(errs),
               errs={f"{k[0]} {k[1]}": v for k, v in errs.items()},
               times=cs.time_pairing(device, clock_hz, products, inverses,
                                     g3, l3, plain_ms),
               product_us=products[(1, 0)]["us"],
               inverse_us=inverses[cs.K8_INV_FORM]["us"])
    ok = not any(errs.values())
    if not check_only:
        r1cs, witness = cs.withdraw_shape_r1cs()
        pk, vk = setup(r1cs, seed=31)
        dpk = tp.DeviceProvingKey(pk, device=device)
        ctx = dict(r1cs=r1cs, vk=vk, dpk=dpk, witness=witness)
        out["verify"] = cs.phase_verify(device, ctx)
        ok &= out["verify"]["ok"]
    print(json.dumps(out, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
