"""What the port's spans (``tpu_zkpool_torch.utils.metrics.span``) cost on
the host.

Times, in ns a call (the least of ``--repeats`` loops, less the least of
as many empty loops): a ``span()`` block, a bare ``record_function``
block, and one tensor op (``torch.add`` on the card if there is one, else
on the CPU) bare and inside three nested spans (30 ops a loop); each with
no profile (where a span is the null context), inside a CPU profile and,
with a card, inside a CPU and CUDA profile, as in a traced run. Prints one
JSON line.

    python3 scripts/span_cost.py [--calls 20000] [--repeats 7]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tpu_zkpool_torch.utils.metrics import span  # noqa: E402

OPS = 30            # tensor ops a loop of the op measures


def per_call_ns(fn, calls: int, repeats: int, per: int = 1) -> float:
    def loop(body):
        t0 = time.perf_counter_ns()
        body(calls)
        return time.perf_counter_ns() - t0

    def empty(n):
        for _ in range(n):
            pass
    base = min(loop(empty) for _ in range(repeats))
    return (min(loop(fn) for _ in range(repeats)) - base) / (calls * per)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20_000)
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    a = torch.ones(4, device=dev)

    def spans(n):
        for _ in range(n):
            with span("prove.upload"):
                pass

    def record_functions(n):
        for _ in range(n):
            with torch.profiler.record_function("prove.upload"):
                pass

    def ops_bare(n):
        for _ in range(n):
            for _ in range(OPS):
                torch.add(a, 1)

    def ops_in_spans(n):
        for _ in range(n):
            with span("msm.a"), span("msm.digits"), span("prove.upload"):
                for _ in range(OPS):
                    torch.add(a, 1)

    states = {"off": None, "cpu": [ProfilerActivity.CPU]}
    if dev == "cuda":
        states["cuda"] = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"device": dev}
    for state, acts in states.items():
        with (profile(activities=acts) if acts
              else contextlib.nullcontext()):
            for name, fn, calls, per in (
                    ("span", spans, args.calls, 1),
                    ("record_function", record_functions, args.calls, 1),
                    ("op_bare", ops_bare, args.calls // OPS, OPS),
                    ("op_in_spans", ops_in_spans, args.calls // OPS, OPS)):
                if acts is None and name == "record_function":
                    continue
                out[f"{name}_{state}_ns"] = round(
                    per_call_ns(fn, calls, args.repeats, per), 1)
            if dev == "cuda":
                torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
