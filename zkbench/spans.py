"""The program's own spans, read from the traced run's Chrome trace.

The port's spans (``tpu_zkpool_torch.utils.metrics.span``: each proof's
phases, the MSM's stages, the witness solve and build) are
``record_function`` annotations of the harness's profile, so the trace it
writes (``zkbench/.cache/trace/window.json``) holds them beside the host's
CUDA calls and the device's records. ``of_run`` reads it once a run:

- only annotations and calls that start inside the ``zkbench.window``
  mark count, so every number is of the profiled stretch, where no
  ``prove(timings=)`` synchronises; the proofs are the ``prove.combine``
  spans under the prover's roots (``prove.proof``, ``prove.batch``);
- a name's time is the union of its annotations on each thread, so a
  wrapper of ``zkbench/trace.py:ANNOTATE`` nested in the span of the same
  name is not counted twice;
- each host CUDA runtime or driver call lies under the annotations open
  over it on its thread, and each kernel, copy and fill belongs to the
  call that made it (kineto's ``correlation`` id);
- launch calls (``utils.profiling.LAUNCH_CALLS``), blocking calls
  (``SYNC_CALLS``) and the bytes of host-to-device copies are summed under
  the roots; the device's busy time (the union of its intervals) for what
  the ``msm.*`` spans launched, and for what ``prove.h_ntt`` launched
  outside ``prove.h_rows``.

A program without the spans (no root in the mark), or a run without the
mark, gives None; so does every device number of a run without a card.
"""

from __future__ import annotations

import bisect
import json
import os
import sys

MARK = "zkbench.window"
ROOTS = ("prove.proof", "prove.batch")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_path(metric_file: str) -> str:
    """The traced run's Chrome trace, beside the metric file's benchmark."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(metric_file))))
    return os.path.join(root, "zkbench", ".cache", "trace", "window.json")


def of_run(run, metric_file: str):
    """``join`` of ``run``'s trace, read once and kept on the run."""
    if not hasattr(run, "span_join"):
        path = trace_path(metric_file)
        run.span_join = None
        if os.path.isfile(path):
            with open(path) as f:
                run.span_join = join(json.load(f), card=run.card is not None)
        if run.span_join is not None:
            print(f"[zkbench] spans, a proof of {run.span_join['proofs']}: "
                  f"{table(run.span_join)}", file=sys.stderr, flush=True)
    return run.span_join


def _union_s(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _open_over(notes, calls):
    """Yield (call index, names of the annotations open over the call on
    its thread, outermost first) for ``calls`` [(ts, tid)], from ``notes``
    {tid: [(start, end, name)]}. Annotations of one thread nest, so a
    sweep with a stack finds them."""
    by_tid = {}
    for k, (ts, tid) in enumerate(calls):
        by_tid.setdefault(tid, []).append((ts, k))
    for tid, cs in by_tid.items():
        ns = sorted(notes.get(tid, []), key=lambda n: (n[0], -n[1]))
        stack, j = [], 0
        for ts, k in sorted(cs):
            while j < len(ns) and ns[j][0] <= ts:
                while stack and stack[-1][1] < ns[j][0]:
                    stack.pop()
                stack.append(ns[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            yield k, [n[2] for n in stack]


def join(trace: dict, card: bool = True):
    """Sums over the marked stretch of a Chrome trace (``trace``, as
    torch.profiler writes it): a dict of ``proofs``, ``span_s`` {name:
    seconds}, ``span_n`` {name: count}; and, with ``card``, ``launches``,
    ``syncs``, ``h2d_bytes``, ``h2d_pageable_bytes``, ``busy_s`` {"msm",
    "hx": seconds, the msm one None if a launch or copy call under an
    ``msm.*`` span has no device record} and ``by_span`` {innermost span
    name: (launches, syncs, busy seconds)}. None without the mark or
    without a proof under a root in it."""
    from tpu_zkpool_torch.utils.profiling import COPY_CALLS, LAUNCH_CALLS
    events = trace.get("traceEvents", [])
    marks = [e for e in events if e.get("name") == MARK
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    notes, by_key = {}, {}
    for e in events:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e.get("name") != MARK and w0 <= float(e["ts"]) <= w1):
            ts = float(e["ts"])
            note = (ts, ts + float(e.get("dur", 0)), e["name"])
            notes.setdefault(e.get("tid"), []).append(note)
            by_key.setdefault((e["name"], e.get("tid")), []).append(
                note[:2])
    roots = {}
    for (name, tid), iv in by_key.items():
        if name in ROOTS:
            roots.setdefault(tid, []).extend(iv)
    starts = {tid: sorted(s for s, _ in iv) for tid, iv in roots.items()}
    ends = {tid: [e for _, e in sorted(iv)] for tid, iv in roots.items()}

    def under_root(ts, tid):
        i = bisect.bisect_right(starts.get(tid, []), ts) - 1
        return i >= 0 and ts <= ends[tid][i]
    proofs = sum(under_root(s, tid)
                 for (name, tid), iv in by_key.items()
                 if name == "prove.combine" for s, _ in _merged(iv))
    if not proofs:
        return None
    span_s, span_n = {}, {}
    for (name, tid), iv in by_key.items():
        merged = _merged(iv)
        span_s[name] = span_s.get(name, 0.0) + sum(
            e - s for s, e in merged) * 1e-6
        span_n[name] = span_n.get(name, 0) + len(merged)
    out = {"proofs": proofs, "span_s": span_s, "span_n": span_n}
    if not card:
        return out

    calls = [e for e in events if e.get("cat") in RUNTIME_CATS
             and e.get("ph") == "X" and w0 <= float(e["ts"]) <= w1]
    device = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            args = e.get("args") or {}
            if args.get("correlation") is not None:
                device.setdefault(args["correlation"], []).append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e.get("name", ""), args.get("bytes", 0)))
    launches = syncs = h2d = pageable = 0
    msm, hx, msm_lost = [], [], False
    by_name = {}        # innermost span name -> [launches, syncs, records]
    for k, names in _open_over(
            notes, [(float(e["ts"]), e.get("tid")) for e in calls]):
        if not any(n in ROOTS for n in names):
            continue
        e = calls[k]
        name = e.get("name", "")
        row = by_name.setdefault(names[-1], [0, 0, []])
        launch = bool(LAUNCH_CALLS.match(name))
        launches += launch
        row[0] += launch
        if name in SYNC_CALLS:
            syncs += 1
            row[1] += 1
        if not (launch or COPY_CALLS.match(name)):
            continue
        recs = device.get((e.get("args") or {}).get("correlation"), [])
        for _, _, rname, nbytes in recs:
            if "HtoD" in rname:
                h2d += nbytes
                pageable += nbytes if "Pageable" in rname else 0
        spans = [r[:2] for r in recs]
        row[2] += spans
        if any(n.startswith("msm.") for n in names):
            msm += spans
            msm_lost = msm_lost or not recs
        if "prove.h_ntt" in names and "prove.h_rows" not in names:
            hx += spans
    out.update(launches=launches, syncs=syncs, h2d_bytes=h2d,
               h2d_pageable_bytes=pageable,
               busy_s={"msm": None if msm_lost else _union_s(msm),
                       "hx": _union_s(hx)},
               by_span={n: (r[0], r[1], _union_s(r[2]))
                        for n, r in by_name.items()})
    return out


def table(j: dict) -> str:
    """The join a proof, span by span: host ms (the span's whole length)
    and how many a proof, and, with a card, the launch and blocking calls
    and the device busy ms of what the span launched itself (its
    children's left out)."""
    n = j["proofs"]
    rows = []
    for name in sorted(j["span_s"], key=lambda k: -j["span_s"][k]):
        line = (f"{name} {j['span_s'][name] * 1e3 / n:.3f} ms x "
                f"{j['span_n'][name] / n:g}")
        if "by_span" in j:
            la, sy, busy = j["by_span"].get(name, (0, 0, 0.0))
            line += (f" / {la / n:.1f} launches / {sy / n:.1f} syncs / "
                     f"{busy * 1e3 / n:.3f} busy ms")
        rows.append(line)
    if "h2d_bytes" in j:
        rows.append(f"host-to-device {j['h2d_bytes'] / n:g} B, pageable "
                    f"{j['h2d_pageable_bytes'] / n:g} B")
    return "; ".join(rows)


def per_proof(run, metric_file: str, key):
    """``key(join)`` / proofs, or None where the join or the value is."""
    j = of_run(run, metric_file)
    if j is None:
        return None
    v = key(j)
    return None if v is None else v / j["proofs"]


def span_ms(j: dict, *names):
    """ms of the spans ``names`` summed (None if none of them ran)."""
    got = [j["span_s"][n] for n in names if n in j["span_s"]]
    return sum(got) * 1e3 if got else None
