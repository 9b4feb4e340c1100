#!/usr/bin/env python3
"""Split the withdraw prover's MSM legs into the grid kernels K1-K6 and
torch glue, on one NVIDIA GPU.

    python3 scripts/msm_leg_split.py     # from a checkout's root

It runs the checkout whose root is the working directory, so that two
commits compare in one call (``cd parent && python3
../change/scripts/msm_leg_split.py``). Two legs at the prover's shapes, c =
13 and 1,024 lanes, complete adds: a G1 leg of 2^14 seeded points and the
G2 leg of 9,216, with random scalars and some identity rows. Each runs one
cold MSM, three warm ones by the host clock (synchronized), and one warm
MSM under torch.profiler, read as ``chip_smoke.profile_prove`` reads a
proof: the device's own events (kernels and copies of one stream) are the
busy time. It prints the card and one JSON line a leg: warm ms, the traced
wall ms, device ms, device launches, each of K1-K6's device ms and
launches, "glue" (the device time and launches of everything else: sort,
searchsorted, gathers, selects, negations, copies) and glue's largest
events.
"""

import json
import os
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_zkpool_torch.fields.limbs import ints_to_limbs  # noqa: E402
from tpu_zkpool_torch.msm import grid, kernels  # noqa: E402

KERNELS = ("k_prefix_rows", "k_prefix", "k_wsum", "k_addn", "k_scale_add",
           "k_horner")
LEGS = ((1, 1 << 14), (2, 9216))


def leg_inputs(ncomp, n, dev, seed=300):
    rng = random.Random(seed + ncomp)
    base = cs._points(ncomp, 4096, seed + 10 * ncomp)
    pts = [base[i % 4096] for i in range(n)]
    for i in range(0, n, 997):
        pts[i] = None                                   # identity rows
    rows = cs._rows(ncomp, pts, rng, affine=True).to(dev)
    limbs = torch.as_tensor(ints_to_limbs(
        [rng.randrange(1, 1 << 254) for _ in range(n)]), device=dev)
    return rows, limbs


def traced(run):
    """(wall ms, {event: (device ms, launches)}) of one run."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - wall) * 1e3
    return wall, {e.key: (e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.self_device_time_total > 0}


def split(events):
    by = {k: [0.0, 0] for k in KERNELS}
    glue = []
    for key, (ms, n) in events.items():
        kern = next((k for k in KERNELS if k + "<" in key), None)
        if kern:
            by[kern][0] += ms
            by[kern][1] += n
        else:
            glue.append((ms, n, key[:70]))
    glue.sort(reverse=True)
    return by, glue


def main():
    if not torch.cuda.is_available():
        print("msm_leg_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(kernels.build),
                  ex.submit(cs.native_bridge.get_lib)]:
            f.result()
    for ncomp, n in LEGS:
        rows, limbs = leg_inputs(ncomp, n, dev)
        msm = lambda: grid.msm_rows(rows, limbs, c=13, lanes=1024)
        msm()
        warm = [cs._host_ms(msm)[0] for _ in range(3)]
        wall, events = traced(msm)
        by, glue = split(events)
        device_ms = sum(ms for ms, _ in events.values())
        glue_ms = sum(g[0] for g in glue)
        print(json.dumps(dict(
            checkout=ROOT, leg="G1" if ncomp == 1 else "G2", points=n,
            warm_ms=warm, wall_ms=wall, device_ms=device_ms,
            device_launches=sum(c for _, c in events.values()),
            kernels={k: dict(device_ms=v[0], launches=v[1])
                     for k, v in by.items()},
            glue=dict(device_ms=glue_ms, launches=sum(g[1] for g in glue)),
            glue_top=[dict(name=k, device_ms=ms, launches=c)
                      for ms, c, k in glue[:10]])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
