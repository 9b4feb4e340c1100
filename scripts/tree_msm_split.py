#!/usr/bin/env python3
"""Split the port's 2^18 ``tree=True`` G1 MSM into K8, its other kernels
and torch glue, on one NVIDIA GPU.

    python3 scripts/tree_msm_split.py          # from a checkout's root

It runs the checkout it sits in: ``chip_smoke.py``'s phase 3 inputs (2^18
seeded points, identity rows, random scalars), one cold MSM, three warm
MSMs by the host clock (synchronized), then one warm MSM under
``chip_smoke.profile_prove``; it prints the card and one JSON line: warm
ms, the traced wall and device ms, K8's device ms and launches, the other
kernels' and the rest (torch glue: the gathers, selects, scans and counts
of ``msm/affine_tree.py:bucket_sums_tree`` and the grid pipeline around
it). It works on checkouts whose ``chip_smoke.py --profile`` has no split
of its own, so that two commits compare in one call.
"""

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_zkpool_torch.msm import grid, kernels  # noqa: E402
from tpu_zkpool_torch.msm import tree_kernels  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("tree_msm_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    with ThreadPoolExecutor(3) as ex:
        for f in [ex.submit(kernels.build), ex.submit(tree_kernels.build),
                  ex.submit(cs.native_bridge.get_lib)]:
            f.result()
    _, g1 = cs.phase_msm(dev)
    msm = lambda: grid.msm_grid_g1(g1["pts_dev"], g1["limbs"], tree=True)
    msm()
    warm = [cs._host_ms(msm)[0] for _ in range(3)]
    p = cs.profile_prove(msm)
    k8 = p["by_kernel"].get("k_tree_level", {"device_ms": 0.0, "count": 0})
    ours = sum(v["device_ms"] for v in p["by_kernel"].values())
    print(json.dumps(dict(
        checkout=ROOT, warm_ms=warm, wall_ms=p["wall_s"] * 1e3,
        device_ms=p["device_busy_s"] * 1e3, k8=k8,
        other_kernels_ms=ours - k8["device_ms"],
        glue_device_ms=p["device_busy_s"] * 1e3 - ours,
        by_kernel=p["by_kernel"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
