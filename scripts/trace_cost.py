"""What recording the port's spans costs a cell of the benchmark, on the
card.

Sets the cell up once, as ``zkbench/run.py`` does, then runs its closed
loop for ``--seconds`` a window in four modes, in turns (``--rounds`` times,
the order reversed every other round): ``off`` (no profile: an untraced
run), ``profile`` (torch.profiler over CPU and CUDA, the spans held to the
null context), ``profile_spans`` (the profile and the program's spans) and
``profile_annotate`` (those and the harness's wrappers,
``zkbench/trace.py:annotate``: a traced run's profiled half). The
profiles are not exported. Prints each window's proofs a second and, last,
one JSON line with the windows and each mode's median. Run from the root
of a checkout:

    python3 scripts/trace_cost.py --workload <cell> --seed <n> \\
        [--seconds 20] [--rounds 2]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODES = ("off", "profile", "profile_spans", "profile_annotate")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    from zkbench import harness, trace
    from zkbench.traffic import ClosedLoop
    from tpu_zkpool_torch.utils import metrics

    if not torch.cuda.is_available():
        print("trace_cost: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cache = os.path.join(ROOT, "zkbench", ".cache")
    cell = harness.Cell(ROOT, args.workload)
    loop = ClosedLoop(cell.traffic, args.seed)
    requests = cell.module("inputs").make(cell.cfg, cell.traffic, args.seed,
                                          cache)
    system = cell.module("system").System(cell.cfg, dev, cache, requests)
    system.serve(*loop.warmup())
    torch.cuda.synchronize(dev)
    # the profiler's flag as the spans read it, and a stand-in that keeps
    # a profile from entering them (the "profile" mode)
    from torch.profiler import ProfilerActivity, profile
    flag = metrics._tprof
    unflagged = types.SimpleNamespace(_is_profiler_enabled=False)

    @contextlib.contextmanager
    def mode(name):
        if name == "off":
            yield
            return
        if name == "profile":
            metrics._tprof = unflagged
        try:
            with contextlib.ExitStack() as stack:
                if name == "profile_annotate":
                    stack.enter_context(trace.annotate())
                stack.enter_context(profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]))
                yield
        finally:
            metrics._tprof = flag

    rates = {m: [] for m in MODES}
    cpu_ms = {m: [] for m in MODES}     # main thread CPU ms a proof
    win = harness.Window(system, loop)
    for r in range(args.rounds):
        for name in (MODES if r % 2 == 0 else MODES[::-1]):
            with mode(name):
                a0, c0 = win.answered, time.thread_time()
                s = win.run(args.seconds)
                torch.cuda.synchronize(dev)
                c1 = time.thread_time()
            n = win.answered - a0
            rates[name].append(n / s)
            cpu_ms[name].append((c1 - c0) * 1e3 / n if n else None)
            print(f"[trace_cost] round {r} {name}: {rates[name][-1]:.4f} "
                  f"proofs/s, {cpu_ms[name][-1]:.3f} CPU ms a proof",
                  file=sys.stderr, flush=True)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(dev), "windows": rates,
           "median": {m: statistics.median(v) for m, v in rates.items()},
           "cpu_ms_a_proof": {m: statistics.median(v)
                              for m, v in cpu_ms.items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
