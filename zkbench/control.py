#!/usr/bin/env python3
"""The control of a cell's correctness check, on the chip: the cell run
as the benchmark runs it, with one guarantee of its configuration broken
underneath. The prover gets the blinding seed of the run's first proof for
every proof, so its proofs still verify but share one blinding; the
reference, which expects each proof's own, has to find them wrong.

    python3 zkbench/control.py --workload <cell> --seeds a,b,c \\
        --seconds <s> [--sound]

prints one JSON line a seed: the seed, ``correct`` and the numbers
compared (``--sound``: the same runs without the fault, for the lower
readings). The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(ROOT, "zkbench", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
sys.path.insert(0, ROOT)

from zkbench import harness  # noqa: E402


def reused_blinding(system_cls):
    """``system_cls`` with ``serve`` given one blinding seed for all: the
    first of the window (its first call is the set-up's warm step)."""
    class Reused(system_cls):
        calls = 0
        first = None

        def serve(self, indices, blind_seed, rec=None):
            Reused.calls += 1
            if Reused.calls == 2:
                Reused.first = blind_seed
            seed = blind_seed if Reused.first is None else Reused.first
            out = []
            for i in indices:        # one request a call: one seed for all
                out += super().serve([i], seed, rec)
            return out
    return Reused


def run(root: str, workload: str, seed: int, seconds: float, sound: bool,
        device=None) -> dict:
    cell = harness.Cell(root, workload)
    mod = cell.module("system")
    orig = mod.System
    if not sound:
        mod.System = reused_blinding(orig)
    try:
        out = harness.run_cell(root, workload, seed, seconds, False,
                               device=device)
    finally:
        mod.System = orig
    return {"seed": seed, "correct": out["correct"], "checks": out["checks"],
            "attempted": out["attempted"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        try:
            line = run(ROOT, args.workload, int(s), args.seconds, args.sound)
        except harness.Failure as e:
            print(f"zkbench control: {e}", file=sys.stderr, flush=True)
            return e.code
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
