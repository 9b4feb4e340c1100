#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 14 alone on one NVIDIA GPU: the kernels the
pod path runs built (K1-K6, K7, K9; the native host library for the
oracle), phase 3's 2^18 G1 inputs against the native oracle
(``phase_msm``), phase 9's sharded MSMs and sharded NTT in one process
(``phase_msm_sharded``, ``phase_ntt``), phase 6's 2^16 root by
``build_levels``, then two processes on the one card (``phase_pod``: the
pod MSM, the gather, the root, and the sharded NTT across the processes
under both exchanges).

    python3 scripts/pod_phase14.py [--out DIR]     # from a checkout's root

It adds no check of its own: it calls ``chip_smoke.py``'s functions, and
re-checks the pod path in a few minutes where the whole ``chip_smoke.py``
runs every phase. It prints the card (``nvidia-smi`` name and power limit)
and one line a part, and exits non-zero if a check fails; a failed worker
raises. The workers' logs go under ``--out`` (default
``chip_smoke_out/``).
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
from tpu_zkpool_torch.fields.fctx import FR  # noqa: E402
from tpu_zkpool_torch.hash import kernels as hkern  # noqa: E402
from tpu_zkpool_torch.merkle import build_levels  # noqa: E402
from tpu_zkpool_torch.msm import kernels  # noqa: E402
from tpu_zkpool_torch.parallel import ntt_rdma  # noqa: E402


def main(argv):
    if not torch.cuda.is_available():
        print("pod_phase14: no CUDA device", file=sys.stderr)
        return 2
    out_dir = (argv[argv.index("--out") + 1] if "--out" in argv
               else os.path.join(ROOT, "chip_smoke_out"))
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        futs = [ex.submit(cuda_build.build, cu)
                for cu in (kernels.SOURCE, hkern.SOURCE, ntt_rdma.SOURCE)]
        futs.append(ex.submit(native_bridge.get_lib))
        for f in futs:
            f.result()
    print(json.dumps(dict(build_s=time.perf_counter() - t0)), flush=True)
    msm, g1 = cs.phase_msm(device)
    print("msm " + json.dumps(msm), flush=True)
    mesh_msm, points = cs.phase_msm_sharded(device, g1)
    print("mesh msm " + json.dumps(mesh_msm), flush=True)
    ntt9 = cs.phase_ntt(device)
    print("mesh ntt " + json.dumps(ntt9), flush=True)
    _, root = build_levels(cs.random_mont((1 << 16,), device, seed=16), 16)
    merkle = dict(root=str(int(FR.from_mont(root.cpu()))))
    t0 = time.perf_counter()
    pod = cs.phase_pod(device, out_dir, g1, points, merkle, ntt9)
    pod["phase_s"] = time.perf_counter() - t0
    for r in pod["ranks"]:
        cs.log_pod_ntt(r)
    print("pod " + json.dumps(pod, default=str), flush=True)
    ok = (msm[1]["ok"] and all(v["ok"] for v in mesh_msm.values())
          and ntt9["ok"] and pod["ok"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
