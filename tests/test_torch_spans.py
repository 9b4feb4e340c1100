"""The port's spans (``tpu_zkpool_torch.utils.metrics.span``): without a
profile ``span()`` is the shared null context and nothing is kept; inside
a torch.profiler profile each span is a user annotation of the trace,
nested per thread; ``prove`` and ``prove_batch`` give every proof the same
spans, and the grid MSM its stages. Beside them the benchmark's reading of
a trace (``zkbench/spans.py``) on hand-written traces, and a traced CPU
run of the harness reading the new per-layer metrics.

On the CPU the MSMs run as plain twins (~3 s a leg even on the tiny
circuit), so the prover's cases stand in a zero point for each MSM's
output: the spans around them are the prover's own. The grid MSM's stage
spans are checked on one small MSM (16-bit scalars).
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.fields.fctx import FP
from tpu_zkpool_torch.groth16 import prove as tp
from tpu_zkpool_torch.msm import grid
from tpu_zkpool_torch.refimpl.groth16_ref import R1CS, setup
from tpu_zkpool_torch.utils import metrics, profiling
from tpu_zkpool_torch.utils.metrics import NULL_SPAN, Metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from zkbench import spans as zspans  # noqa: E402

torch.set_num_threads(1)

DISPATCH = ("prove.pack_witness", "prove.upload", "msm.a", "msm.b1",
            "msm.b2", "prove.h_ntt", "prove.h_rows", "msm.h", "msm.k")
PER_PROOF = ("prove.dispatch",) + DISPATCH + ("prove.fetch",
                                              "prove.combine")


def _tiny_circuit():
    return R1CS(num_vars=5, num_public=2,
                a_rows=[{2: 1}, {3: 1}, {}],
                b_rows=[{2: 1}, {2: 1}, {0: 1}],
                c_rows=[{3: 1}, {4: 1},
                        {1: 1, 4: -1 % R, 2: -1 % R, 0: -5 % R}])


def _witness(x):
    return [1, x**3 + x + 5, x, x * x, x**3]


def _zero_msm(points, scalar_limbs, **kw):
    z = torch.zeros(points[0].shape[1:], dtype=torch.int64)
    return z, z, z


def _annotations(tmp_path, fn, all_threads=False):
    """[(name, tid, start, end)] of the user annotations of a CPU profile
    of ``fn()``, in order of start; of every thread's with
    ``all_threads``, else of this thread's."""
    from torch._C._profiler import _ExperimentalConfig
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=all_threads)) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["tid"], e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"),
                  key=lambda n: n[2])


def _inside(inner, outer):
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3])


@pytest.fixture
def tiny_prover(monkeypatch):
    monkeypatch.setattr(tp, "msm_grid_g1", _zero_msm)
    monkeypatch.setattr(tp, "msm_grid_g2", _zero_msm)
    r1cs = _tiny_circuit()
    pk, _ = setup(r1cs)
    return tp.DeviceProvingKey(pk, c=8, lanes=32, device="cpu"), r1cs


def test_recording_off_records_nothing():
    m = Metrics()
    s = metrics.span("prove.proof")
    assert s is NULL_SPAN and metrics.span("b") is NULL_SPAN
    with s:
        pass
    with m.timer("t"):
        pass
    assert m.snapshot()["timings"]["t"]["count"] == 1   # always kept
    assert set(vars(m)) == {"_lock", "_counters", "_timings"}


def test_spans_nest_per_thread(tmp_path):
    barrier = threading.Barrier(2)

    def work():
        with metrics.span("root"):
            barrier.wait()              # both roots open at once
            with metrics.span("child"):
                with metrics.span("leaf"):
                    torch.ones(8).sum()
                    barrier.wait()

    def both():
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    got = _annotations(tmp_path, both, all_threads=True)
    assert sorted(n[0] for n in got) == ["child"] * 2 + ["leaf"] * 2 + [
        "root"] * 2
    assert len({n[1] for n in got}) == 2
    for leaf in (n for n in got if n[0] == "leaf"):
        (child,) = [n for n in got if n[0] == "child" and _inside(leaf, n)]
        (root,) = [n for n in got if n[0] == "root" and _inside(child, n)]


def test_timer_is_a_span_while_recording(tmp_path):
    m = Metrics()

    def relay():
        with m.timer("relayer.withdraw_s"):
            torch.ones(8).sum()
    got = _annotations(tmp_path, relay)
    assert [n[0] for n in got] == ["relayer.withdraw_s"]
    snap = m.snapshot()["timings"]["relayer.withdraw_s"]
    assert snap["count"] == 1 and snap["total_s"] >= 0


def test_spans_are_the_profiles_annotations(tmp_path):
    def loop():
        for _ in range(20):
            with metrics.span("outer"):
                torch.ones(64).sum()
                with metrics.span("inner"):
                    torch.ones(64).sum()
    got = _annotations(tmp_path, loop)
    outer = [n for n in got if n[0] == "outer"]
    inner = [n for n in got if n[0] == "inner"]
    assert len(outer) == len(inner) == 20 == len(got) // 2
    for i, o in zip(inner, outer):
        assert _inside(i, o)
    assert metrics.span("outer") is NULL_SPAN       # the profile is over


@pytest.mark.parametrize("entry", ["prove", "prove_batch", "prove_timed"])
def test_every_proof_gets_its_spans(tiny_prover, tmp_path, entry):
    dpk, r1cs = tiny_prover
    ws = [_witness(x) for x in (3, 4, 5)]
    timings = []

    def run():
        if entry == "prove_batch":
            tp.prove_batch(dpk, r1cs, ws, seed=11)
            return
        for i, w in enumerate(ws):
            t = {} if entry == "prove_timed" else None
            tp.prove(dpk, r1cs, w, seed=11 + i, timings=t)
            timings.append(t)
    got = _annotations(tmp_path, run)
    root = "prove.batch" if entry == "prove_batch" else "prove.proof"
    roots = [n for n in got if n[0] in zspans.ROOTS]
    assert {n[0] for n in roots} == {root}
    assert len(roots) == (1 if entry == "prove_batch" else 3)
    for name in PER_PROOF:
        spans = [n for n in got if n[0] == name]
        assert len(spans) == 3, name
        assert all(any(_inside(s, r) for r in roots) for s in spans)
    for d in (n for n in got if n[0] == "prove.dispatch"):
        assert sorted(n[0] for n in got if n is not d and _inside(n, d)) \
            == sorted(DISPATCH)
    if entry == "prove_timed":
        for t in timings:
            assert set(t) == {"upload", "msm_a", "msm_b1", "msm_b2", "h_rows",
                              "h_ntt", "msm_h", "msm_k", "combine"}


@pytest.mark.parametrize("ncomp", [1, 2])
def test_msm_stage_spans(tmp_path, ncomp):
    n, c, nbits = 32, 8, 16
    g = torch.Generator().manual_seed(ncomp)
    base = grid._safe_point(ncomp, "cpu")       # (2, ncomp, 16), on curve
    X = base[0].expand(n, ncomp, 16).clone()
    Y = base[1].expand(n, ncomp, 16).clone()
    Z = FP.ones_mont((n,), "cpu")
    if ncomp == 2:
        Z = torch.stack([Z, torch.zeros_like(Z)], 1)
    else:
        X, Y = X[:, 0], Y[:, 0]
    scal = torch.zeros((n, 16), dtype=torch.int64)
    scal[:, 0] = torch.randint(0, 1 << 15, (n,), generator=g)
    msm = grid.msm_grid_g1 if ncomp == 1 else grid.msm_grid_g2

    def leg():
        with metrics.span("msm.a"):
            msm((X, Y, Z), scal, c=c, lanes=32, nbits=nbits)
    got = _annotations(tmp_path, leg)
    (a,) = [n for n in got if n[0] == "msm.a"]
    stages = [n for n in got if n is not a]
    assert [n[0] for n in stages] == [
        "msm.stack", "msm.digits", "msm.buckets", "msm.reduce",
        "msm.horner"]
    assert all(_inside(s, a) for s in stages)


def _ev(name, cat, ts, dur, tid=1, corr=None, nbytes=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    if nbytes is not None:
        e["args"]["bytes"] = nbytes
    return e


def _note(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


def test_h2d_bytes_equal_the_uploaded_arrays():
    """The host-to-device copies under a root, pageable or pinned, and
    neither the copy back nor an upload outside the prover."""
    ev = [_note("zkbench.window", 0, 3000), _note("prove.batch", 10, 990),
          _note("prove.combine", 900, 50)]
    copies = [("Memcpy HtoD (Pageable -> Device)", 100, 4096),
              ("Memcpy HtoD (Pinned -> Device)", 200, 1024),
              ("Memcpy DtoH (Device -> Pageable)", 300, 512),
              ("Memcpy HtoD (Pageable -> Device)", 1500, 999)]
    for corr, (rec, ts, nbytes) in enumerate(copies):
        ev.append(_ev("cudaMemcpyAsync", "cuda_runtime", ts, 5, corr=corr))
        ev.append(_ev(rec, "gpu_memcpy", ts + 10, 3, tid=7, corr=corr,
                      nbytes=nbytes))
    j = zspans.join({"traceEvents": ev})
    assert j["proofs"] == 1
    assert (j["h2d_bytes"], j["h2d_pageable_bytes"]) == (4096 + 1024, 4096)


@pytest.mark.parametrize("annotate", [False, True])
@pytest.mark.parametrize("lost", [False, True])
def test_join_assigns_kernels_to_the_innermost_span(lost, annotate):
    """The program's spans, with (``annotate``) the benchmark's own
    wrappers of the same names nested in them (``zkbench/trace.py:
    ANNOTATE``), and the host's calls with their device records; ``lost``
    drops one kernel record under an MSM span."""
    ev = [_note("zkbench.window", -1000, 4000),
          _note("prove.proof", 100, 900), _note("msm.a", 110, 300),
          _note("msm.digits", 120, 100), _note("prove.h_ntt", 500, 200),
          _note("prove.h_rows", 510, 50), _note("prove.fetch", 720, 100),
          _note("prove.combine", 830, 150)]
    if annotate:
        ev += [_note("prove.h_rows", 515, 20), _note("msm.g1", 111, 290),
               _note("prove.combine", 835, 140)]
    launches = [("cudaLaunchKernel", 130, 11, 200, 10),   # msm.digits
                ("cudaLaunchKernel", 300, 12, 400, 20),   # msm.a
                ("cudaMemcpyAsync", 545, 13, 560, 30),    # h_rows: not H(X)
                ("cudaLaunchKernel", 600, 14, 650, 40),   # h_ntt
                ("cudaLaunchKernel", 1500, 15, 1600, 5)]  # outside the spans
    for name, ts, corr, kts, kdur in launches:
        ev.append(_ev(name, "cuda_runtime", ts, 2, corr=corr))
        if not (lost and corr == 11):
            cat = "gpu_memcpy" if "Memcpy" in name else "kernel"
            rec = "Memcpy HtoD (Pageable -> Device)" if "Memcpy" in name \
                else "k"
            ev.append(_ev(rec, cat, kts, kdur, tid=7, corr=corr,
                          nbytes=64 if "Memcpy" in name else None))
    ev.append(_ev("cudaStreamSynchronize", "cuda_runtime", 730, 50))
    trace = {"traceEvents": ev}
    j = zspans.join(trace)
    assert j["proofs"] == 1
    assert j["launches"] == 3 and j["syncs"] == 1 and j["h2d_bytes"] == 64
    assert j["busy_s"]["hx"] == pytest.approx(40e-6)
    if lost:
        assert j["busy_s"]["msm"] is None
    else:
        assert j["busy_s"]["msm"] == pytest.approx(30e-6)
    assert j["span_s"]["prove.combine"] == pytest.approx(150e-6)
    assert j["span_s"]["prove.h_rows"] == pytest.approx(50e-6)
    assert j["span_n"]["prove.h_rows"] == 1
    assert j["by_span"]["prove.h_rows"][2] == pytest.approx(30e-6)
    assert j["by_span"]["prove.fetch"][1] == 1
    cpu = zspans.join(trace, card=False)
    assert "launches" not in cpu and "busy_s" not in cpu
    assert cpu["span_s"] == j["span_s"]


@pytest.mark.parametrize("missing", ["roots", "mark"])
def test_join_without_the_programs_spans_gives_none(missing):
    """A program without the spans (only the benchmark's wrappers, as
    before the spans existed) or a trace without the mark reads None."""
    ev = [_note("zkbench.window", 0, 3000), _note("prove.combine", 830, 150),
          _note("prove.fetch", 700, 100),
          _ev("cudaLaunchKernel", "cuda_runtime", 720, 2, corr=1),
          _ev("k", "kernel", 740, 5, tid=7, corr=1)]
    if missing == "mark":
        ev = ev[1:] + [_note("prove.proof", 600, 400)]
    assert zspans.join({"traceEvents": ev}) is None


def test_split_launches_leaves_out_the_spans_rows():
    """The card's rows of the spans' annotations are not kernels."""
    from torch.autograd import DeviceType

    def row(key, device, note=False):
        return types.SimpleNamespace(key=key, count=2, device_type=device,
                                     is_user_annotation=note)
    launches, kernels, copies = profiling.split_launches([
        row("cudaLaunchKernel", DeviceType.CPU),
        row("cudaMemcpyAsync", DeviceType.CPU),
        row("k_horner", DeviceType.CUDA),
        row("msm.horner", DeviceType.CUDA, note=True),
        row("msm.horner", DeviceType.CPU, note=True)])
    assert launches == {"cudaLaunchKernel": 2}
    assert kernels == {"k_horner": 2}
    assert copies == {"cudaMemcpyAsync": 2}


SYSTEM = '''
from zkbench.ref import withdraw_judge
from zkbench.ref.groth16 import blinding


class System:
    """Answers with the reference's proofs; beside them each step runs the
    port's prove_batch on a tiny circuit, for its spans."""

    def __init__(self, cfg, device, cache_dir, requests):
        import os
        from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
        from tpu_zkpool_torch.groth16 import acir, prove, r1cs, solver_native
        from tpu_zkpool_torch.refimpl.groth16_ref import R1CS, setup
        from zkbench.ref import withdraw_acir
        path = os.path.join(cache_dir, "spans.json")
        wp = withdraw_acir.withdraw_program(cfg["depth"])
        withdraw_acir.write_artifact(path, wp.program, wp.abi)
        _, self.program = acir.load_artifact(path)
        self.ar = r1cs.convert(self.program)
        self.r1cs, self.solver, self.prove = r1cs, solver_native, prove
        self.judge = withdraw_judge.reference(cfg)
        self.requests = requests
        self.tiny = R1CS(num_vars=5, num_public=2,
                         a_rows=[{2: 1}, {3: 1}, {}],
                         b_rows=[{2: 1}, {2: 1}, {0: 1}],
                         c_rows=[{3: 1}, {4: 1},
                                 {1: 1, 4: -1 % R, 2: -1 % R, 0: -5 % R}])
        pk, _ = setup(self.tiny)
        self.dpk = prove.DeviceProvingKey(pk, c=8, lanes=32, device="cpu")
        self.msm_points = {"g1": [32], "g2": []}

    def serve(self, indices, blind_seed, rec=None):
        ws = [self.r1cs.build_witness(
            self.ar, self.solver.solve(self.program, self.requests[k]))
            for k in indices]
        self.prove.prove_batch(
            self.dpk, self.tiny,
            [[1, x**3 + x + 5, x, x * x, x**3] for x in range(3, 3 + len(ws))],
            seed=blind_seed)
        return [{"proof": self.judge.expected(w, *blinding(blind_seed + i)),
                 "witness": w} for i, w in enumerate(ws)]
'''

RUN = r'''
import json, sys
import torch
root, seed, repo = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path[:0] = [root, repo]
from tpu_zkpool_torch.groth16 import prove


def zero_msm(points, scalar_limbs, **kw):
    z = torch.zeros(points[0].shape[1:], dtype=torch.int64)
    return z, z, z


prove.msm_grid_g1 = prove.msm_grid_g2 = zero_msm
from zkbench import harness
out = harness.run_cell(root, "tiny.closed", seed, 0.01, True, device="cpu",
                       log=lambda m: None)
print(json.dumps(out))
'''

NEW_METRICS = ("combine_span_ms", "upload_rows_span_ms", "fetch_wait_ms",
               "h2d_mb_per_proof", "launches_per_proof",
               "host_syncs_per_proof", "hx_busy_ms", "msm_busy_roofline")


def test_harness_traced_cpu_run_reads_the_spans(tmp_path):
    """A traced run of a tiny cell on the CPU reports the span metrics and
    none of the card's (no card). In a subprocess: the harness refuses a
    process that has loaded JAX, as this test process has."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(ROOT, "zkbench"), root / "zkbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    z = root / "zkbench"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(z / "configs" / "withdraw-d16.json") as f:
        cfg = json.load(f)
    cfg.update(name="tiny", depth=1, leaves=2, owned_notes=2,
               system="zkbench/systems/spans_standin.py")
    (z / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (z / "systems" / "spans_standin.py").write_text(SYSTEM)
    (z / "traffic" / "tiny.json").write_text(json.dumps(
        {"loop": "closed", "batch": 2, "distinct": 2, "check_share": 1.0}))
    cell = {"name": "tiny.closed", "config": "tiny", "traffic": "tiny",
            "chips": 1, "why": "a CPU cell"}
    (z / "workloads" / "tiny.closed.json").write_text(json.dumps(
        {k: cell[k] for k in ("config", "traffic", "chips", "why")}))
    bench["workloads"].append(cell)
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS:
            m["workloads"].append("tiny.closed")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = subprocess.run([sys.executable, "-c", RUN, str(root),
                        str(2**31 + 977), ROOT], capture_output=True,
                       text=True, timeout=600, cwd=str(root))
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    got = out["metrics"]
    for name in NEW_METRICS[:3]:
        assert got[name]["value"] > 0, name
        assert got[name]["unit"] == "ms"
    for name in NEW_METRICS[3:] + ("device_idle",):
        assert name not in got, name
