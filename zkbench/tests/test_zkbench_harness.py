"""CPU tests of the benchmark harness (``zkbench``): a cell, a configuration
and a metric found from new files alone, the traffic's determinism, the
MSM work count, the reference against the port on a tiny withdraw circuit,
the faults the correctness check must catch, the result line, and the
import guard.

    python -m pytest zkbench/tests -q -n 0
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from zkbench import harness, work  # noqa: E402
from zkbench.gen import withdraw as gen_withdraw  # noqa: E402
from zkbench.traffic import ClosedLoop  # noqa: E402

SEED = 2**31 + 977          # larger than 32 signed bits hold

# A stand-in prover: the port's own solve for the witness, and for the
# proof the reference's expected one, broken as the configuration's
# ``fault`` says. It drives a whole run on the CPU in seconds.
STANDIN = '''
from zkbench.ref import withdraw_judge
from zkbench.ref.groth16 import blinding


class System:
    def __init__(self, cfg, device, cache_dir, requests):
        from tpu_zkpool_torch.groth16 import acir, r1cs, solver_native
        from zkbench.ref import withdraw_acir
        import os
        path = os.path.join(cache_dir, "standin.json")
        wp = withdraw_acir.withdraw_program(cfg["depth"])
        withdraw_acir.write_artifact(path, wp.program, wp.abi)
        _, self.program = acir.load_artifact(path)
        self.ar = r1cs.convert(self.program)
        self.solve = lambda req: r1cs.build_witness(
            self.ar, solver_native.solve(self.program, req))
        self.judge = withdraw_judge.reference(cfg)
        self.requests, self.fault = requests, cfg.get("fault")
        self.last = None
        self.msm_points = {"g1": [len(self.ar.r1cs.a_rows)], "g2": []}

    def serve(self, indices, blind_seed, rec=None):
        out = []
        for i, k in enumerate(indices):
            w = self.solve(self.requests[k])
            if rec is not None:
                rec.span("solve", 0.001)
            A, B, C = self.judge.expected(w, *blinding(blind_seed + i))
            if self.fault == "alter" and i == 0:
                C = A
            out.append({"proof": (A, B, C), "witness": w})
        if self.fault == "half":
            out = out[: len(out) // 2]
        if self.fault == "stale":
            out, self.last = (self.last or out), out
        return out
'''

METRIC = '''
def read(run):
    return float(len(run.spans.get("solve", [])))
'''


def make_root(tmp_path, fault=None, batch=2, leak=None):
    """A benchmark root with the repository's ``zkbench`` and, as new files
    only, a tiny withdraw configuration served by the stand-in prover, its
    traffic, its cell and a metric of its own. ``leak`` ("metric" or
    "reference") adds a file of that kind that imports ``flax``, here a
    stand-in package at the root."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(ROOT, "zkbench"), root / "zkbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    z = root / "zkbench"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(z / "configs" / "withdraw-d16.json") as f:
        cfg = json.load(f)
    cfg.update(name="tiny", depth=1, leaves=2, owned_notes=2, fault=fault,
               system="zkbench/systems/standin.py")
    (z / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (z / "systems" / "standin.py").write_text(STANDIN)
    (z / "metrics" / "solves.py").write_text(METRIC)
    (z / "traffic" / "tiny.json").write_text(json.dumps(
        {"loop": "closed", "batch": batch, "distinct": 2,
         "check_share": 1.0}))
    cell = {"name": "tiny.closed", "config": "tiny", "traffic": "tiny",
            "chips": 1, "why": "a data-only cell"}
    (z / "workloads" / "tiny.closed.json").write_text(json.dumps(
        {k: cell[k] for k in ("config", "traffic", "chips", "why")}))
    bench["workloads"].append(cell)
    bench["per_layer"].append(
        {"name": "solves", "unit": "1", "better": "higher",
         "source": "program_span", "layer": "witness",
         "moves": "proofs_per_s", "workloads": ["tiny.closed"]})
    if leak:
        (root / "flax").mkdir()
        (root / "flax" / "__init__.py").write_text("STANDIN = True\n")
    if leak == "metric":
        (z / "metrics" / "leaky.py").write_text(
            "import flax  # noqa: F401\n\n\ndef read(run):\n"
            "    return 1.0\n")
        bench["per_layer"].append(
            {"name": "leaky", "unit": "1", "better": "higher",
             "source": "program_span", "layer": "witness",
             "moves": "proofs_per_s", "workloads": ["tiny.closed"]})
    if leak == "reference":
        (z / "ref" / "leaky_judge.py").write_text(
            "import flax  # noqa: F401\n"
            "from zkbench.ref.withdraw_judge import judge  # noqa: F401\n")
        cfg["reference"] = "zkbench/ref/leaky_judge.py"
        (z / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def quiet(msg):
    pass


def test_new_files_only_cell_config_metric(tmp_path):
    root = make_root(tmp_path)
    out = harness.run_cell(root, "tiny.closed", SEED, 0.01, False,
                           device="cpu", log=quiet)
    assert out["correct"] is True
    assert out["metrics"]["proofs_per_s"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert set(out["checks"]) == {"proofs_wrong", "publics_wrong",
                                  "witness_rows_failed", "answers_missing"}
    traced = harness.run_cell(root, "tiny.closed", SEED, 0.01, True,
                              device="cpu", log=quiet)
    assert traced["correct"] is True
    assert traced["metrics"]["solves"]["value"] >= 2
    assert "device_idle" not in traced["metrics"]     # no card, no number


def test_result_line_shape(tmp_path):
    root = make_root(tmp_path)
    out = harness.run_cell(root, "tiny.closed", SEED + 1, 0.01, False,
                           device="cpu", log=quiet)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        out["device"])
    json.dumps(out)


@pytest.mark.parametrize("fault", ["alter", "half", "stale"])
def test_faults_come_out_not_correct(tmp_path, fault):
    root = make_root(tmp_path, fault=fault)
    out = harness.run_cell(root, "tiny.closed", SEED, 0.01, False,
                           device="cpu", log=quiet)
    assert out["correct"] is False
    bad = {k: c["value"] for k, c in out["checks"].items()
           if c["value"] > c["limit"]}
    assert bad, out["checks"]


def test_run_without_card_prints_no_result(tmp_path):
    root = make_root(tmp_path)
    p = subprocess.run([sys.executable, "zkbench/run.py", "--workload",
                        "tiny.closed", "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


LEAK_RUN = r'''
import sys
root, seed = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
from zkbench import harness
try:
    harness.run_cell(root, "tiny.closed", seed, 0.01, True, device="cpu")
except harness.Failure as e:
    print(f"zkbench: {e}", file=sys.stderr)
    sys.exit(e.code)
print("a result")
'''


@pytest.mark.parametrize("leak", ["metric", "reference"])
def test_jax_loaded_after_the_window_prints_no_result(tmp_path, leak):
    """A data-only metric or reference that loads a forbidden module (a
    stand-in ``flax``) after the window has closed: the run exits with 3
    and prints no result, naming the module."""
    root = make_root(tmp_path, leak=leak)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", LEAK_RUN, root, str(SEED)],
                       capture_output=True, text=True, timeout=300,
                       env={**env, "PYTHONPATH": ROOT})
    assert p.returncode == 3, p.stderr[-2000:]
    assert p.stdout.strip() == ""
    assert "flax" in p.stderr


def test_judge_columns_match_the_rows(tmp_path):
    """U, V, W at tau from the cached columns equal the row-by-row sums,
    and a Judge built from given columns expects the same proof."""
    from zkbench.ref import withdraw_judge
    from zkbench.ref.groth16 import Judge, blinding
    from zkbench.systems import withdraw as sys_withdraw
    cfg = {"depth": 1, "pool_seed": 5, "owned_notes": 2, "setup_seed": 1337}
    reqs = gen_withdraw.requests(cfg, 1, SEED, str(tmp_path / "c"))
    j = withdraw_judge.reference(cfg)
    from tpu_zkpool_torch.groth16 import r1cs, solver_native
    prog = sys_withdraw.withdraw_acir.withdraw_program(1).program
    w = r1cs.build_witness(r1cs.convert(prog), solver_native.solve(
        prog, reqs[0]))
    u, v, x, bad = j.evaluate(w)
    assert bad == 0 and j.at_tau(w) == (u, v, x)
    assert j.at_tau(w[:-1]) is None
    again = Judge(j.r1cs, 1337, columns=j.columns())
    rs = blinding(77)
    assert again.expected(w, *rs, again.at_tau(w)) == j.expected(w, *rs)


def test_traffic_is_deterministic_in_the_seed(tmp_path):
    params = {"batch": 16, "distinct": 64, "check_share": 0.15}
    a, b = ClosedLoop(params, SEED), ClosedLoop(params, SEED)
    assert [a.step(k) for k in range(9)] == [b.step(k) for k in range(9)]
    picked = [j for j in range(2000) if a.judged(j)]
    assert picked == [j for j in range(2000) if b.judged(j)]
    assert 200 < len(picked) < 400
    assert picked != [j for j in range(2000)
                      if ClosedLoop(params, SEED + 1).judged(j)]
    blinds = [a.step(k)[1] + j for k in range(9) for j in range(16)]
    assert len(set(blinds)) == len(blinds)
    cfg = {"depth": 3, "pool_seed": 7, "owned_notes": 6}
    cache = str(tmp_path / "c")
    r1 = gen_withdraw.requests(cfg, 4, SEED, cache)
    r2 = gen_withdraw.requests(cfg, 4, SEED, cache)       # from the cache
    r3 = gen_withdraw.requests(cfg, 4, SEED + 1, cache)
    assert r1 == r2 and r1 != r3
    assert len({r[9] for r in r1}) == 4                    # distinct notes


def test_audit_inputs_are_deterministic_in_the_seed():
    from zkbench.gen import audit as gen_audit
    cfg = {"auditor_keys": 2}
    d1 = gen_audit.make(cfg, {"distinct": 2}, SEED, None)
    d2 = gen_audit.make(cfg, {"distinct": 2}, SEED, None)
    assert [(d["wa"], d["ct"]) for d in d1] == [(d["wa"], d["ct"])
                                               for d in d2]
    assert d1[0]["key"] != d1[1]["key"]                    # two keys


def _brute_pippenger(scalars, c):
    """A signed-digit Pippenger over the integers mod 2^254 + 1 standing in
    for the group, counting its mixed additions, additions and doublings;
    returns (sum, counts). Every digit of the scalars used is non-zero."""
    mod = (1 << 254) + 1
    counts = {"madd": 0, "add": 0, "dbl": 0}
    windows = -(-254 // c)
    half = 1 << (c - 1)
    digits = []
    for k in scalars:
        ds, carry = [], 0
        for w in range(windows):
            d = ((k >> (w * c)) & ((1 << c) - 1)) + carry
            carry = 0
            if d > half:
                d -= 1 << c
                carry = 1
            ds.append(d)
        digits.append(ds)
    acc = None
    for w in reversed(range(windows)):
        buckets = [None] * (half + 1)
        for p, ds in enumerate(digits):
            d = ds[w]
            pt = (p + 1) if d > 0 else -(p + 1)
            counts["madd"] += 1
            b = buckets[abs(d)]
            buckets[abs(d)] = pt if b is None else b + pt
        run = tot = None
        for b in range(half, 0, -1):
            s = buckets[b] or 0
            if run is None:
                run = s
            else:
                run += s
                counts["add"] += 1
            if tot is None:
                tot = run
            else:
                tot += run
                counts["add"] += 1
        if acc is None:
            acc = tot
        else:
            for _ in range(c):
                acc *= 2
                counts["dbl"] += 1
            acc += tot
            counts["add"] += 1
    return acc % mod, counts


def _nonzero_digit_scalar(rng, c):
    """A 253-bit scalar whose signed c-bit digits are all non-zero."""
    windows = -(-254 // c)
    while True:
        k = rng.getrandbits(253)
        ok, carry = True, 0
        for w in range(windows):
            d = ((k >> (w * c)) & ((1 << c) - 1)) + carry
            carry = 0
            if d > 1 << (c - 1):
                d -= 1 << c
                carry = 1
            ok &= d != 0
        if ok and carry == 0:
            return k


@pytest.mark.parametrize("c", [3, 4, 6])
def test_msm_work_count_matches_a_brute_count(c):
    import random
    rng = random.Random(c)
    n = 40
    scalars = [_nonzero_digit_scalar(rng, c) for _ in range(n)]
    total, counts = _brute_pippenger(scalars, c)
    # the point p + 1 stands for the p-th base: the sum is sum (p+1) k_p
    assert total == sum((p + 1) * k for p, k in enumerate(scalars)) % (
        (1 << 254) + 1)
    assert counts["madd"] == n * -(-254 // c)
    assert (counts["madd"] * work.MADD + counts["add"] * work.ADD
            + counts["dbl"] * work.DBL) == work.products(n, c)
    assert work.least_products(n)[0] <= work.products(n, c)
    assert work.least_products(n, "g2")[0] == 3 * work.least_products(n)[0]


def test_least_time_reads_the_peaks():
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    t, bound = work.least_seconds(1 << 21, "g1", peak)
    prods, c = work.least_products(1 << 21)
    assert bound == "ops" and c == 17
    assert t == pytest.approx(prods * 264 / (132 * 64 * 1.98e9))
    assert work.peaks("a card with no row") is None


def test_reference_matches_the_port_on_a_tiny_withdraw_circuit(tmp_path):
    """The port's solve and CPU prove (the twins, c = 8, 32 lanes) at depth
    1, judged by the frozen reference: every number 0; one proof element
    swapped and one blinding seed off are both found."""
    import torch
    from zkbench.ref import withdraw_judge
    from zkbench.systems import withdraw as sys_withdraw
    torch.set_num_threads(2)
    cfg = {"depth": 1, "pool_seed": 5, "owned_notes": 2, "setup_seed": 1337,
           "msm": {"c": 8, "lanes": 32, "complete": True, "tree": False}}
    cache = str(tmp_path / "c")
    reqs = gen_withdraw.requests(cfg, 2, SEED, cache)
    system = sys_withdraw.System(cfg, "cpu", cache, reqs)
    got = system.serve([0, 1], 4242)
    answers = [{**a, "request": i, "blind": 4242 + i}
               for i, a in enumerate(got)]
    assert withdraw_judge.judge(cfg, reqs, answers) == {
        "proofs_wrong": 0, "publics_wrong": 0, "witness_rows_failed": 0}
    a, b, c = answers[0]["proof"]
    answers[0] = {**answers[0], "proof": (a, b, a)}
    answers[1] = {**answers[1], "blind": 4242}
    assert withdraw_judge.judge(cfg, reqs, answers)["proofs_wrong"] == 2


IMPORT_ALL = r'''
import importlib, os, sys
root, only = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
for d, _, files in os.walk(os.path.join(root, "zkbench", only)):
    if "tests" in d or ".cache" in d:
        continue
    for f in sorted(files):
        if f.endswith(".py") and f != "__init__.py":
            rel = os.path.relpath(os.path.join(d, f), root)[:-3]
            importlib.import_module(rel.replace(os.sep, "."))
if only == "":
    import tpu_zkpool_torch.groth16.prove, tpu_zkpool_torch.groth16.acir
    import tpu_zkpool_torch.groth16.r1cs, tpu_zkpool_torch.groth16.cache
    import tpu_zkpool_torch.groth16.solver_native
    import tpu_zkpool_torch.protocol.audit_circuit
print(sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "tpu_zkpool", "tpu_zkpool_torch"}))
'''


def _imported_top_levels(only: str) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", IMPORT_ALL, ROOT, only],
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"'))


def test_no_module_loads_jax_or_the_jax_package():
    """Every module under ``zkbench`` (``run.py`` and the harness among
    them) and the port's entry points the systems call load neither JAX
    nor ``tpu_zkpool``: top-level names compared whole, since the port's
    own name begins with the JAX package's."""
    assert _imported_top_levels("") == ["tpu_zkpool_torch"]


def test_the_reference_loads_nothing_of_the_port():
    """The reference's files (``zkbench/ref``) load neither the port nor
    JAX nor the JAX package."""
    assert _imported_top_levels("ref") == []
