#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s sharded-NTT part of phase 9 alone, on one NVIDIA
GPU: K9 built (``-Xptxas -v``), held to its twin (``check_exchange``),
timed at the audit ring's shape (``time_exchange``), and the sharded
negacyclic products at D = 2, 4, 8 under both exchanges (``phase_ntt``).

    python3 scripts/ntt_phase9.py        # from a checkout's root

It runs the checkout whose root is the working directory, so that two
commits compare in one call (``cd parent && python3
../change/scripts/ntt_phase9.py``). It prints the card (``nvidia-smi`` name
and power limit), K9's ptxas lines and one JSON line: the checks' case
count, launches and largest difference, the stage timings and the
products' runs as those functions return them, and a torch.profiler trace
of one warm product at D = 8 under rdma (a graph replay where the checkout
has one): wall ms, the summed device ms of its kernels and copies (slot
streams overlap, so the sum may pass the wall), K9's device ms and
launches, the events with the most time. It exits non-zero if a check
fails.
"""

import json
import os
import sys
import time

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_zkpool_torch.parallel import Mesh, ntt_rdma, ntt_sharded  # noqa: E402


def trace_product(device, n=1024, B=4096, D=8):
    """One warm D-shard rdma product under torch.profiler."""
    a, b = cs.random_q((B, n), device, 110), cs.random_q((B, n), device, 111)
    mesh = Mesh.virtual((D,), ("sp",), device)
    run = lambda: ntt_sharded.negacyclic_mul_sharded(a, b, mesh,
                                                     exchange="rdma")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    k9 = [r for r in rows if "k_exchange_butterfly" in r[1]]
    return dict(wall_ms=wall * 1e3, device_ms=sum(r[0] for r in rows) / 1e3,
                device_events=sum(r[2] for r in rows),
                k9_ms=sum(r[0] for r in k9) / 1e3,
                k9_launches=sum(r[2] for r in k9),
                top=[dict(name=k[:60], ms=us / 1e3, count=c)
                     for us, k, c in rows[:8]])


def main():
    if not torch.cuda.is_available():
        print("ntt_phase9: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    clock = cs.nvidia_smi("clocks.max.sm").split()[0:1]
    clock_hz = float(clock[0]) * 1e6 if clock else 1.98e9
    t0 = time.perf_counter()
    _, ptxas = ntt_rdma.build(["-Xptxas", "-v"])
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    print("\n".join(line for line in (ptxas or "").splitlines()
                    if "registers" in line or "Compiling" in line))
    errs, launches = cs.check_exchange(device)
    stage = cs.time_exchange(device, clock_hz)
    ntt = cs.phase_ntt(device)
    res = dict(root=os.path.basename(ROOT), check_cases=len(errs),
               check_launches=launches, check_max_err=max(errs.values()),
               stage=stage, ntt=ntt, trace=trace_product(device))
    print(json.dumps(res, default=str), flush=True)
    ok = not res["check_max_err"] and not stage["max_abs_err"] and ntt["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
