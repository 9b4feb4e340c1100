"""One run of one cell: set-up, a measured window, the judgement of the
window's answers by the plain reference, and the result line.

Everything a cell needs is found by name from data files under the
benchmark's root: the cell ``zkbench/workloads/<cell>.json`` (its
``config``, ``traffic``, ``chips``, ``why``), the configuration
``zkbench/configs/<config>.json`` (its sizes, guarantees, the limits of the
numbers its reference compares, and the files of its ``inputs``,
``system`` and ``reference`` modules), the traffic mix
``zkbench/traffic/<traffic>.json`` (``traffic.ClosedLoop``), and each
metric ``zkbench/metrics/<metric>.py`` (a ``read(run)`` that returns a
number, or None where the run has nothing to read). ``BENCHMARK.json``
says which metrics a cell reports.

A configuration's modules:

- inputs: ``make(cfg, traffic, seed, cache_dir)`` -> the requests (a list;
  made by the benchmark, never by the program);
- system: ``System(cfg, device, cache_dir, requests)``, the program set up,
  with ``serve(indices, blind_seed, rec=None)`` -> one answer (a dict with
  ``proof``) a request, the timed entry, and ``msm_points``;
- reference: ``judge(cfg, requests, answers, cache_dir)`` -> {number:
  value}, each held to ``cfg["limits"][number]``; what it works out once
  a checkout it may keep in ``cache_dir``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time

from zkbench import trace as trace_mod
from zkbench.traffic import ClosedLoop

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_zkpool")


class Failure(Exception):
    """A run that prints no result: exit with ``code``."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def load_json(root: str, *parts) -> dict:
    path = os.path.join(root, *parts)
    if not os.path.isfile(path):
        raise Failure(f"no file {os.path.relpath(path, root)}")
    with open(path) as f:
        return json.load(f)


def load_module(root: str, rel: str):
    """The Python file ``rel`` (relative to ``root``) as a module."""
    path = os.path.join(root, rel)
    if not os.path.isfile(path):
        raise Failure(f"no file {rel}")
    name = "zkbench_file_" + rel.replace("/", "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell and everything it names, read from ``root``."""

    def __init__(self, root: str, name: str):
        self.root, self.name = root, name
        bench = load_json(root, "BENCHMARK.json")
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise Failure(f"no workload {name!r} in BENCHMARK.json")
        self.spec = load_json(root, "zkbench", "workloads", name + ".json")
        for key in ("config", "traffic", "chips"):
            if self.spec[key] != entry[0][key]:
                raise Failure(f"{name}: {key} differs between its file and "
                              "BENCHMARK.json")
        self.cfg = load_json(root, "zkbench", "configs",
                             self.spec["config"] + ".json")
        self.traffic = load_json(root, "zkbench", "traffic",
                                 self.spec["traffic"] + ".json")
        self.chips = int(self.spec["chips"])

        def applies(m):
            return "workloads" not in m or name in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    def module(self, key: str):
        return load_module(self.root, self.cfg[key])

    def metric(self, name: str):
        return load_module(self.root, f"zkbench/metrics/{name}.py")


class Run:
    """What a run records; the metrics read it."""

    def __init__(self):
        self.setup_s = None
        self.window_s = None
        self.answered = 0            # answers of the timed window
        self.spans: dict = {}        # name -> [seconds]
        self.timings: list = []      # a dict of prover phases a proof
        self.profile = None          # trace.reduce_trace of the traced part
        self.msm_points = None
        self.card = None
        self.power_limit_w = None

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def timing(self, phases: dict) -> None:
        self.timings.append(dict(phases))


def process_age() -> float:
    """Seconds since this process started (from /proc; 0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _power_limit():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _steal_s() -> float:
    """Seconds the hypervisor held back this machine's CPUs, summed over
    them (/proc/stat's ``steal``; 0 where absent)."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


class HostLoad:
    """What the host did over a stretch, for the log beside each window:
    the main thread's and the process's CPU seconds, the involuntary
    context switches, the CPU time the hypervisor stole, and the cyclic
    garbage collector's passes by generation and their pauses."""

    def __init__(self):
        self.gc_s = 0.0
        self.gc_n = [0, 0, 0]
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n[info["generation"]] += 1
            self._t = None

    def __enter__(self):
        import resource
        self._r0 = resource.getrusage(resource.RUSAGE_SELF)
        self._c0 = (time.perf_counter(), time.thread_time(),
                    time.process_time(), _steal_s())
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        import resource
        gc.callbacks.remove(self._gc)
        r = resource.getrusage(resource.RUSAGE_SELF)
        w, t, p, st = (b - a for a, b in zip(self._c0, (
            time.perf_counter(), time.thread_time(), time.process_time(),
            _steal_s())))
        self.summary = (
            f"wall {w:.3f} s, main thread CPU {t:.3f} s, process CPU "
            f"{p:.3f} s, stolen {st:.2f} CPU s, involuntary switches "
            f"{r.ru_nivcsw - self._r0.ru_nivcsw}, voluntary "
            f"{r.ru_nvcsw - self._r0.ru_nvcsw}; gc passes by generation "
            f"{self.gc_n}, paused {self.gc_s:.3f} s")


def quartiles(xs: list) -> str:
    if len(xs) < 2:
        return " / ".join(f"{x:.4f}" for x in xs)
    q = statistics.quantiles(xs, n=4)
    return (f"{min(xs):.4f} / {q[0]:.4f} / {q[1]:.4f} / {q[2]:.4f} / "
            f"{max(xs):.4f}")


class Window:
    """The closed loop of a window: steps until ``seconds`` have passed.
    The answers the reference is to judge are kept with their request and
    blinding seed; the others are counted."""

    def __init__(self, system, loop: ClosedLoop):
        self.system, self.loop = system, loop
        self.judged: list = []
        self.answered = 0
        self.attempted = 0
        self.k = 0
        self.step_s: list = []
        self.step_cpu: list = []

    def step(self, rec=None) -> None:
        t0, c0 = time.perf_counter(), time.thread_time()
        idx, blind = self.loop.step(self.k)
        self.k += 1
        got = self.system.serve(idx, blind, rec) or []
        for j, ans in enumerate(got[:len(idx)]):
            if self.loop.judged(self.attempted + j):
                self.judged.append({**ans, "request": idx[j],
                                    "blind": blind + j})
        self.attempted += len(idx)
        self.answered += min(len(got), len(idx))
        self.step_s.append(time.perf_counter() - t0)
        self.step_cpu.append(time.thread_time() - c0)

    def run(self, seconds: float, rec=None) -> float:
        t0 = time.perf_counter()
        while True:
            self.step(rec)
            if time.perf_counter() - t0 >= seconds:
                return time.perf_counter() - t0


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device=None, log=None) -> dict:
    """One run; returns the result (``checks`` last). ``device`` None
    means the chip: CUDA, as many cards as the cell asks for."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_proc = time.perf_counter() - process_age()
    cell = Cell(root, workload)
    if device is None:
        if not torch.cuda.is_available():
            raise Failure("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise Failure(f"{cell.chips} cards asked for, "
                          f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cache = os.path.join(root, "zkbench", ".cache")
    loop = ClosedLoop(cell.traffic, seed)
    rec = Run()
    if device.type == "cuda":
        rec.card = torch.cuda.get_device_name(device)
        rec.power_limit_w = _power_limit()

    requests = cell.module("inputs").make(cell.cfg, cell.traffic, seed, cache)
    system = cell.module("system").System(cell.cfg, device, cache, requests)
    rec.msm_points = getattr(system, "msm_points", None)
    warm_idx, warm_blind = loop.warmup()
    system.serve(warm_idx, warm_blind)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec.setup_s = time.perf_counter() - t_proc
    log(f"[zkbench] {workload}: set-up {rec.setup_s:.3f} s")

    gc.collect()
    win = Window(system, loop)
    missing_labels = []
    if not traced:
        with HostLoad() as load:
            rec.window_s = win.run(seconds)
        rec.answered = win.answered
        log(f"[zkbench] window: {load.summary}")
    else:
        # two halves: the profiler alone (after one step inside the
        # profile), then the prover's phase clocks and the spans alone
        path = os.path.join(cache, "trace", "window.json")
        with trace_mod.annotate() as missing_labels, \
                trace_mod.profiled(path):
            win.step()
            with torch.profiler.record_function(trace_mod.MARK):
                win.run(seconds / 2)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        rec.profile = trace_mod.reduce_trace(path)
        win.run(seconds / 2, rec)
        if missing_labels:
            log("[zkbench] trace labels with no function to wrap: "
                + ", ".join(missing_labels))

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    answers, attempted, answered = win.judged, win.attempted, win.answered
    if win.step_s:
        half = len(win.step_s) // 2
        log(f"[zkbench] {len(win.step_s)} steps; least / quartiles / most "
            f"s: wall {quartiles(win.step_s)}, main thread CPU "
            f"{quartiles(win.step_cpu)}; the first {half} "
            f"{sum(win.step_s[:half]):.3f} s, the rest "
            f"{sum(win.step_s[half:]):.3f} s")
    del system, win
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = judge(cell, requests, answers, attempted - answered, cache,
                    log)
    limits = cell.cfg["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": rec.card or str(device), "count": cell.chips,
           "memory_peak_bytes": peak, "power_limit_w": rec.power_limit_w}
    out = {"correct": correct, "attempted": attempted,
           "failed": numbers.get("answers_missing", 0)
           + numbers.get("proofs_wrong", 0),
           "metrics": metrics, "device": dev}
    if traced and rec.profile:
        dev["busy_s"] = rec.profile["busy_s"]
        dev["window_s"] = rec.profile["window_s"]
        out["breakdown"] = {"device_ops": rec.profile["device_ops"],
                            "idle_gaps": rec.profile["idle_gaps"]}
    if traced:
        out["trace_labels_missing"] = missing_labels
    out["checks"] = checks
    # last, so that whatever the reference and the metrics loaded counts
    bad = forbidden_modules()
    if bad:
        raise Failure(f"modules loaded in the run: {', '.join(bad)}", 3)
    return out


def judge(cell: Cell, requests: list, answers: list, missing: int,
          cache_dir: str, log) -> dict:
    """The numbers the reference compares: the answers drawn for judging,
    judged, and the answers that never came."""
    t0 = time.perf_counter()
    numbers = cell.module("reference").judge(cell.cfg, requests, answers,
                                             cache_dir)
    numbers["answers_missing"] = missing
    log(f"[zkbench] reference: {len(answers)} answers judged in "
        f"{time.perf_counter() - t0:.3f} s")
    return numbers


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        out = run_cell(root, args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except Failure as e:
        print(f"zkbench: {e}", file=sys.stderr, flush=True)
        return e.code
    print(json.dumps(out), flush=True)
    return 0
