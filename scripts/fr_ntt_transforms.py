#!/usr/bin/env python3
"""Time the Fr NTT transforms and the prover's H(X) pipeline of the
checkout this runs from, on one NVIDIA GPU, through its public functions
only (``groth16.domain`` and ``prove._h_pipeline``), so that two commits
compare in one call: run it from each checkout's root, in turns.

    cd CHECKOUT && python3 /path/to/fr_ntt_transforms.py [--label NAME]
        [--reps N] [--json PATH]

At n = 2^14, P = 3 (the withdraw proof's domain and polynomials) and n =
2^21, P = 1 (the var-PK proof's) it times ``forward``, ``inverse``,
``interpolate_natural``, ``coset_forward`` and ``coset_inverse`` on seeded
Montgomery values, and the pipeline (``_h_pipeline``, split from 2^20) on
3 seeded polynomials: CUDA-event means over ``reps`` calls after a warm
one, and in a CUDA graph (the device's time without the host's launch
gaps), with each call's kernel launches from the checkout's
``ntt_kernels.LAUNCHES`` and a digest of its output (equal digests: equal
results across checkouts). It prints one JSON line with the card's
``nvidia-smi`` name and power limit, and exits 2 without a GPU.
"""

import json
import os
import subprocess
import sys

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from tpu_zkpool_torch.fields.bn254 import FR_MOD  # noqa: E402
from tpu_zkpool_torch.groth16 import domain  # noqa: E402
from tpu_zkpool_torch.groth16 import ntt_kernels as nk  # noqa: E402
from tpu_zkpool_torch.groth16 import prove as tp  # noqa: E402

SIZES = ((14, 3), (21, 1))     # (log n, P)


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def values(shape, device, seed):
    """Seeded canonical Montgomery Fr limbs (top limb below r's)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=g,
                      device=device, dtype=torch.int64)
    x[..., 15] %= FR_MOD >> 240
    return x


def digest(x):
    """An int64 digest of limbs (wrapping sum of limb x position)."""
    w = torch.arange(1, x.numel() + 1, device=x.device, dtype=torch.int64)
    return int((x.reshape(-1) * w).sum())


def events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return events_ms(graph.replay, 3) / reps


def main(argv):
    if not torch.cuda.is_available():
        print("fr_ntt_transforms: no CUDA device", file=sys.stderr)
        return 2
    label = argv[argv.index("--label") + 1] if "--label" in argv else ROOT
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 20
    dev = torch.device("cuda", 0)
    out = dict(label=label, card=card(), rows={})
    for log_n, P in SIZES:
        n = 1 << log_n
        t = domain.tables(n, dev)
        y = values((P, n), dev, 11 + log_n)
        fns = {
            "forward": lambda: domain.forward(y, t["fwd"]),
            "inverse": lambda: domain.inverse(y, t["inv"], t["ninv"]),
            "interpolate_natural": lambda: domain.interpolate_natural(
                y, t["br"], t["inv"], t["ninv"]),
            "coset_forward": lambda: domain.coset_forward(y, t["coset"],
                                                          t["fwd"]),
            "coset_inverse": lambda: domain.coset_inverse(
                y, t["coset_inv"], t["inv"], t["ninv"])}
        evs = values((3, n), dev, 12 + log_n)
        tinv = values((), dev, 13 + log_n)
        pipe = (tp._h_pipeline_split if n >= tp._H_SPLIT_MIN_N
                else tp._h_pipeline)
        fns["h_pipeline"] = lambda: pipe(evs, tinv, t, True)
        r = reps if log_n < 20 else max(reps // 4, 3)
        for name, fn in fns.items():
            nk.reset_launches()
            res = fn()
            torch.cuda.synchronize()
            row = dict(launches=dict(nk.LAUNCHES), digest=digest(res))
            del res
            row["ms"] = events_ms(fn, r)
            row["graph_ms"] = graph_ms(fn, r)
            out["rows"][f"{name} 2^{log_n} P={P}"] = row
            print(f"{label} {name} 2^{log_n} P={P}: " + json.dumps(row),
                  flush=True)
        del y, evs
        torch.cuda.empty_cache()
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
