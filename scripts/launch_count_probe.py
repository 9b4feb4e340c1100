"""Are the A8 launch counts of ``chip_smoke.py`` phase 12 deterministic?

Phase 12 extrapolates the kernel launches of a keygen loop
(``FixedBaseTable.mul``, one window a step) and of ``CurveOps.scalar_mul``
(one bit a step) from torch.profiler profiles of 1 and 2 steps as base + n
x step, and holds a keygen's line at n = 4 to one whole profile of 4
windows, name by name (``checks["keygen_launch_line"]``). This script
repeats that comparison many times in one process, on the card, at phase
12's shapes: the c = 8 embedded table with the keygen digits of B = 256
identities, and a 128-bit ``scalar_mul`` of B = 256 lanes of the embedded
generator. Each repeat profiles both loops at 1, 2 and 4 steps through
``tpu_zkpool_torch.utils.profiling.kernel_launches``, the count phase 12
uses, and keeps per-name dicts of the host's launch calls (the count), of
the card's kernel records and of the copy and fill calls; the keygen is
also profiled with 10 ms of idle card inside the profile before and after
the call, and read event by event. Repeats run in four allocator states:
right after the table's build ("fresh"), after ``torch.cuda.empty_cache()``,
after the rest of phase 12's A8 work (whole keygens at B = 1, 256, 1,024, a
whole scalar multiplication; "after_a8"), and after ``empty_cache()``
following that work. Once a state, the aten ops dispatched
(``TorchDispatchMode``) and a profile with the host's activity on are
counted too.

It prints which names vary, by how much and in which state, the kernel
records the profiler lost (launch calls less kernel records), and whether
each repeat's line equals its whole profile name by name; the whole record
goes to ``--json``. Exit 0 when every repeat's line of launch calls equals
its whole profile name by name, 1 when one does not, 2 without a card.

    python3 scripts/launch_count_probe.py [--repeats 24] [--json PATH]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import random
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpu_zkpool_torch.curve import fixed_base, weierstrass  # noqa: E402
from tpu_zkpool_torch.utils.profiling import (  # noqa: E402
    kernel_launches, launch_line, split_launches)

B = 256                      # phase 12's batch (POOL_B)
KEYGEN_BS = (1, 256, 1024)   # phase 12's keygen batches
STEPS = (1, 2, 4)            # the line's two profiles, then the whole one
SEED = 601                   # phase 12's seed
# the committed identity's key (chip_smoke.py, tests/vectors.py)
SECRET_KEY = 0x43F5147FE5A665DF7600DA3AE1C0AE1C
PAD_S = 0.01                 # idle card around a padded profile's call
STATES = ("fresh", "empty_cache", "after_a8", "after_a8_empty_cache")
COUNTS = ("launches", "kernels", "copies")


class _AtenCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def loops(device):
    """{name: step_fn(n)} of phase 12's two loops at B = 256, and the
    table, digits, bits and points the A8 work between states reuses."""
    C = weierstrass.EMBEDDED
    tbl = fixed_base.embedded_generator_table(8, device=device)
    rng = random.Random(SEED + 1)
    ks = [SECRET_KEY, 0, 1, C.order - 1, (1 << 128) - 1] + [
        rng.getrandbits(128) for _ in range(max(KEYGEN_BS) - 5)]
    digits = {b: torch.as_tensor(tbl.digits(ks[:b]), device=device)
              for b in KEYGEN_BS}
    rng = random.Random(SEED + 128)
    sks = [0, 1, (1 << 128) - 1] + [rng.getrandbits(128)
                                    for _ in range(B - 3)]
    bits = torch.as_tensor(C.bits_from_ints(sks, 128), device=device)
    G = C.from_affine_ints([C.gen[0]] * B, [C.gen[1]] * B, device=device)
    fns = {"keygen": lambda n: tbl.mul(digits[B][:, :n]),
           "scalar_mul": lambda n: C.scalar_mul(bits[:, :n], G)}
    return fns, tbl, digits, bits, G


def a8_work(tbl, digits, bits, G):
    """The rest of phase 12's A8 work: whole keygens at each batch, a
    whole 128-bit scalar multiplication, add and double."""
    C = weierstrass.EMBEDDED
    for d in digits.values():
        tbl.mul(d)
    P = C.scalar_mul(bits, G)
    C.add(C.double(P), G)
    torch.cuda.synchronize()


def diff(a, b):
    """{name: (a's, b's)} where two per-name dicts differ."""
    return {n: (a.get(n, 0), b.get(n, 0)) for n in sorted(set(a) | set(b))
            if a.get(n, 0) != b.get(n, 0)}


def padded(fn):
    """One profile of ``fn()`` with PAD_S of idle card inside the profile
    before and after the call: its launch calls, and its kernel records
    read event by event (their count, distinct (name, start) pairs, the
    first start in us from the profile's start)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    launches, kernels, _ = split_launches(prof.key_averages())
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.key in kernels]
    return dict(launches=sum(launches.values()), kernels=len(dev),
                distinct=len({(e.name, e.time_range.start) for e in dev}),
                first_us=min((e.time_range.start for e in dev), default=0))


def repeat(fns):
    """One repeat: for each loop the launch calls, kernel records and copy
    calls at each of STEPS, and each count's line at the last step against
    its whole profile, name by name; the keygen also ``padded``."""
    rec = {}
    for name, fn in fns.items():
        r = rec[name] = {}
        for n in STEPS:
            _, *counts = kernel_launches(lambda: fn(n))
            r[n] = dict(zip(COUNTS, counts))
        k = STEPS[-1]
        for what in COUNTS:
            r[f"{what}_line_vs_whole"] = diff(
                launch_line(r[1][what], r[2][what], k), r[k][what])
    rec["keygen_padded"] = {n: padded(lambda: fns["keygen"](n))
                            for n in STEPS}
    return rec


def host_view(fns):
    """Per loop and step: the aten ops dispatched (TorchDispatchMode), and
    one profile with the host's activity on: aten ops, launch calls,
    kernel records, copy calls."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn in fns.items():
        o = out[name] = {}
        for n in STEPS:
            m = _AtenCount()
            with m:
                fn(n)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn(n)
                torch.cuda.synchronize()
            rows = prof.key_averages()
            counts = split_launches(rows)
            o[n] = dict(aten_dispatched=m.ops, aten_profiled=sum(
                e.count for e in rows if e.key.startswith("aten::")),
                **{w: sum(c.values()) for w, c in zip(COUNTS, counts)})
    return out


def variation(reps, name, what, n):
    """{name: {state: (min, max)}} over the repeats of the names whose
    count at n steps varies."""
    keys = set().union(*(r[name][n][what] for _, r in reps))
    seen = collections.defaultdict(lambda: collections.defaultdict(list))
    for state, rec in reps:
        for k in keys:
            seen[k][state].append(rec[name][n][what].get(k, 0))
    return {k: {s: (min(vs), max(vs)) for s, vs in by.items()}
            for k, by in seen.items()
            if len({v for vs in by.values() for v in vs}) > 1}


def lost(reps, name, n):
    """{state: (min, max)} of the kernel records lost at n steps: launch
    calls less kernel records."""
    by = collections.defaultdict(list)
    for state, rec in reps:
        r = rec[name][n]
        by[state].append(sum(r["launches"].values())
                         - sum(r["kernels"].values()))
    return {s: (min(v), max(v)) for s, v in by.items()}


def summarize(reps, views, fns):
    """Per loop: each count's distinct totals and varying names by step,
    the kernel records lost by state, the repeats whose line missed, the
    host views; the keygen's padded profiles."""
    out = {"card": torch.cuda.get_device_name(0), "repeats": len(reps),
           "states": list(STATES)}
    for name in fns:
        out[name] = {
            "totals": {f"{what}@{n}": sorted(
                {sum(r[name][n][what].values()) for _, r in reps})
                for what in COUNTS for n in STEPS},
            "varying": {f"{what}@{n}": variation(reps, name, what, n)
                        for what in COUNTS for n in STEPS},
            "kernel_records_lost": {n: lost(reps, name, n) for n in STEPS},
            "line_missed": {what: [(s, i, r[name][f"{what}_line_vs_whole"])
                                   for i, (s, r) in enumerate(reps)
                                   if r[name][f"{what}_line_vs_whole"]]
                            for what in COUNTS},
            "host_view": {s: v[name] for s, v in views.items()},
        }
    pads = [r["keygen_padded"] for _, r in reps]
    out["keygen_padded"] = {n: {
        "launches": sorted({p[n]["launches"] for p in pads}),
        "kernels": sorted({p[n]["kernels"] for p in pads}),
        "kernels_minus_distinct": sorted({p[n]["kernels"] - p[n]["distinct"]
                                          for p in pads}),
        "first_us": [min(p[n]["first_us"] for p in pads),
                     max(p[n]["first_us"] for p in pads)],
    } for n in STEPS}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=24,
                    help="repeats in all, over the four states in turn")
    ap.add_argument("--json", help="write the whole record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_count_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    fns, tbl, digits, bits, G = loops(device)
    for fn in fns.values():          # first-use constants, unprofiled
        fn(1)
    torch.cuda.synchronize()
    print(f"table and inputs {time.perf_counter() - t0:.1f} s", flush=True)

    reps, views = [], {}
    per_state = -(-args.repeats // len(STATES))
    for state in STATES:
        if state.startswith("after_a8"):
            a8_work(tbl, digits, bits, G)
        for i in range(per_state):
            if state.endswith("empty_cache"):
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            rec = repeat(fns)
            reps.append((state, rec))
            print(f"{state} {i}: " + "; ".join(
                f"{k} " + ", ".join(
                    f"{sum(rec[k][n]['launches'].values())} launches / "
                    f"{sum(rec[k][n]['kernels'].values())} kernel records"
                    f" @{n}" for n in STEPS)
                + f", launch line misses "
                  f"{json.dumps(rec[k]['launches_line_vs_whole'])}"
                for k in fns)
                + f"; keygen padded {json.dumps(rec['keygen_padded'])}; "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
        views[state] = host_view(fns)

    summary = summarize(reps, views, fns)
    summary["s"] = time.perf_counter() - t0
    print(json.dumps(summary, default=str))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(summary, reps=reps), f, default=str)
    ok = not any(summary[name]["line_missed"]["launches"] for name in fns)
    print(f"every repeat's line of launch calls equals its whole profile, "
          f"name by name: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
