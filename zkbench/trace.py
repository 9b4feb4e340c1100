"""The traced run's device record: a torch.profiler trace over a steady
stretch of work, reduced to the card's busy time, the device operations
that took most time and the host's activity in the card's idle gaps.

The profiler loses some of the card's records at a profile's start, so the
measured stretch begins after one step of work inside the profile: a
``record_function("zkbench.window")`` marks it, and only device records
inside the mark count. Busy time is the union of the card's kernel, copy
and fill intervals in the mark; a gap is named by the innermost host
annotation over its midpoint (the harness's own spans and the prover
functions ``annotate`` wraps, ``host`` where none is open).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "zkbench.window"

# Host functions of the port named in the idle gaps: (module, attribute,
# label). A name the port no longer has is skipped, and reported.
ANNOTATE = (
    ("tpu_zkpool_torch.groth16.prove", "_dispatch_legs", "prove.dispatch"),
    ("tpu_zkpool_torch.groth16.prove", "_witness_u64", "prove.pack_witness"),
    ("tpu_zkpool_torch.groth16.prove", "_scalar_limbs", "prove.upload"),
    ("tpu_zkpool_torch.groth16.prove", "msm_grid_g1", "msm.g1"),
    ("tpu_zkpool_torch.groth16.prove", "msm_grid_g2", "msm.g2"),
    ("tpu_zkpool_torch.groth16.prove", "compute_h_device", "prove.h"),
    ("tpu_zkpool_torch.groth16.solver_native", "eval_rows_native",
     "prove.h_rows"),
    ("tpu_zkpool_torch.groth16.prove", "_fetch", "prove.fetch"),
    ("tpu_zkpool_torch.groth16.prove", "_finish_proof", "prove.combine"),
)


@contextlib.contextmanager
def annotate():
    """Wrap the ``ANNOTATE`` functions in ``record_function`` for the
    duration (the traced stretch only). Yields the list of
    ``module.attribute`` names that were not found, so that a label lost
    to a rename shows."""
    import torch
    saved, missing = [], []
    for mod_name, attr, label in ANNOTATE:
        try:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
        except (ImportError, AttributeError):
            missing.append(f"{mod_name}.{attr}")
            continue

        def wrap(fn=fn, label=label):
            @functools.wraps(fn)
            def inner(*a, **k):
                with torch.profiler.record_function(label):
                    return fn(*a, **k)
            return inner
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrap())
    try:
        yield missing
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(path: str, top: int = 10) -> dict:
    """busy_s, window_s, device_ops and idle_gaps of the marked stretch of
    a Chrome trace that torch.profiler exported; None if no mark."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    marks = [e for e in events if e.get("name") == MARK
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev, host = [], []
    for e in events:
        if "dur" not in e or e.get("ph") != "X":
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                dev.append((s0, s1, e.get("name", "?")))
        elif e.get("cat") == "user_annotation" and e.get("name") != MARK:
            host.append((s, s + d, e["name"]))
    busy = _union([(s, e) for s, e, _ in dev])
    ops = {}
    for s, e, name in dev:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-6
    gaps, t = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            mid = (s + t) / 2
            over = [(he - hs, n) for hs, he, n in host if hs <= mid <= he]
            label = min(over)[1] if over else "host"
            gaps[label] = gaps.get(label, 0.0) + (s - t) * 1e-6
        t = max(t, e)
    busy_s = sum(e - s for s, e in busy) * 1e-6

    def ranked(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


@contextlib.contextmanager
def profiled(path: str):
    """A torch.profiler profile of CPU and CUDA activity, exported to
    ``path`` as a Chrome trace at the end."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
