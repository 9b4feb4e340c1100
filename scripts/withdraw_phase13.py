#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 13 alone on one NVIDIA GPU: the kernels the
withdraw path runs built (K1-K6, K7, P1 and P2; the two native host
libraries), the MSM benchmark's 2^17 inputs against their committed point
(``bench_msm``, phase 3's last line), then the withdraw proof from an ACIR
program (``phase_withdraw``: the generated artifact solved by the
interpreter and natively, ``examples/torch_withdraw_e2e.py`` on it, the
demo app with real proofs over HTTP, the naive pairing at B = 4).

    python3 scripts/withdraw_phase13.py [--out DIR]     # from a checkout's root

It adds no check of its own: it calls ``chip_smoke.py``'s functions. It
exists because the whole ``chip_smoke.py`` builds every kernel and runs
every phase (about 750 s of its 1,200 s limit), while this re-checks the
withdraw path in about three minutes, as ``scripts/pairing_phase10.py``
and ``scripts/audit_phase11.py`` do for phases 10 and 11.

It prints the card (``nvidia-smi`` name and power limit) and one JSON line
a part, and exits non-zero if a check fails. Files (the artifact, the
app's store) go under ``--out`` (default ``chip_smoke_out/``).
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
from tpu_zkpool_torch.msm import kernels  # noqa: E402


def main(argv):
    if not torch.cuda.is_available():
        print("withdraw_phase13: no CUDA device", file=sys.stderr)
        return 2
    out_dir = (argv[argv.index("--out") + 1] if "--out" in argv
               else os.path.join(ROOT, "chip_smoke_out"))
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    cus = [kernels.SOURCE, hkern.SOURCE, pkern.SOURCE]
    with ThreadPoolExecutor(len(cus) + 2) as ex:
        futs = [ex.submit(cuda_build.build, cu) for cu in cus]
        futs += [ex.submit(native_bridge.get_lib),
                 ex.submit(solver_native.get_lib)]
        for f in futs:
            f.result()
    print(json.dumps(dict(build_s=time.perf_counter() - t0)), flush=True)
    bench = cs.bench_msm(device)
    print("bench " + json.dumps(bench), flush=True)
    withdraw = cs.phase_withdraw(device, out_dir)
    print(json.dumps(withdraw, default=str), flush=True)
    return 0 if bench["ok"] and withdraw["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
