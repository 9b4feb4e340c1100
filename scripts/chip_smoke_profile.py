#!/usr/bin/env python3
"""Run ``chip_smoke.py`` on one NVIDIA GPU with every one of its functions,
and the plain twins and host oracles it calls, timed: where its wall time
goes, phase by phase and function by function.

    python3 scripts/chip_smoke_profile.py [chip_smoke.py's arguments]

Each function of ``chip_smoke.py`` and each ``*_plain`` twin of the
modules it checks kernels against (``msm.grid``, ``hash.poseidon``,
``msm.affine_tree``, ``curve.pairing``, ``hash.poseidon2``,
``groth16.domain``), the host oracles (``refimpl.curve_ref``,
``refimpl.pedersen``, ``pairing_ref.pairing`` / ``g1_mul`` / ``g2_mul``),
``pairing_product_is_one`` and ``setup`` is wrapped by a timer before
``chip_smoke.main`` runs. A function's seconds include those of the
functions it calls (a nested call counts in both). Every log line of
``chip_smoke.py`` is followed by ``@@ <s from the start> [phase]``. At
the end the 60 largest totals go to standard error, one
``PROFILE <s> <calls>x <name>`` line each, and all of them to
``chip_smoke_profile.json`` in ``chip_smoke.py``'s ``--out`` directory
(default ``chip_smoke_out/``). The wrappers cost about a
microsecond a call (the host oracles make ~10^6 calls). The script's
exit code is ``chip_smoke.py``'s.
"""

from __future__ import annotations

import collections
import functools
import inspect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

SECONDS = collections.defaultdict(float)
CALLS = collections.Counter()
T0 = time.perf_counter()
ORACLES = ("pairing", "pairing_product_is_one", "g1_mul", "g2_mul")


def wrap(owner, name, label):
    """Replace ``owner.name`` by a timed call of it, counted as ``label``."""
    f = getattr(owner, name)

    @functools.wraps(f)
    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return f(*a, **k)
        finally:
            SECONDS[label] += time.perf_counter() - t
            CALLS[label] += 1

    setattr(owner, name, timed)


def wrap_all():
    for name, f in list(vars(cs).items()):
        if (inspect.isfunction(f) and f.__module__ == cs.__name__
                and name not in ("main", "log", "nvidia_smi")):
            wrap(cs, name, name)
    for name in ("setup", "cached_setup"):
        wrap(cs, name, name)
    for m in (cs.grid, cs.poseidon, cs.affine_tree, cs.pairing,
              cs.poseidon2, cs.domain, cs.curve_ref, cs.pr, cs.pedersen):
        whole = m in (cs.curve_ref, cs.pedersen)
        for name, f in list(vars(m).items()):
            if (inspect.isfunction(f) and f.__module__ == m.__name__
                    and (whole or name.endswith("_plain")
                         or name in ORACLES)):
                wrap(m, name, f"{m.__name__.rsplit('.', 1)[-1]}.{name}")
    log = cs.log

    def stamped(phase, msg):
        log(phase, msg)
        print(f"@@ {time.perf_counter() - T0:.1f} [{phase}]", flush=True)

    cs.log = stamped


def report(argv):
    rows = sorted(SECONDS.items(), key=lambda kv: -kv[1])
    out = (argv[argv.index("--out") + 1] if "--out" in argv
           else os.path.join(ROOT, "chip_smoke_out"))
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_smoke_profile.json"), "w") as f:
        json.dump(dict(total_s=time.perf_counter() - T0,
                       functions=[[k, v, CALLS[k]] for k, v in rows]),
                  f, indent=0)
    print(f"PROFILE total {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    for k, v in rows[:60]:
        print(f"PROFILE {v:9.2f} s {CALLS[k]:7d}x {k}", file=sys.stderr)


def main(argv):
    wrap_all()
    try:
        return cs.main(argv)
    finally:
        report(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
