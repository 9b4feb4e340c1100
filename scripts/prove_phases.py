#!/usr/bin/env python3
"""Per-phase seconds of withdraw-shape proofs on one NVIDIA GPU, from a
checkout's root.

    python3 scripts/prove_phases.py [--proofs N]    # from a checkout's root

It runs the checkout whose root is the working directory (its
``tpu_zkpool_torch`` and ``chip_smoke.py``), so that two commits compare in
one call (``cd parent && python3 ../change/scripts/prove_phases.py``): it
builds the grid-MSM kernels, sets up ``chip_smoke.withdraw_shape_r1cs`` as
phase 4 does (setup seed 31), proves once cold, then N (default 5) proofs
with ``timings=`` (the device synchronized around each phase: ``upload``,
``msm_a``, ``msm_b1``, ``msm_b2``, ``h_ntt``, ``msm_h``, ``msm_k``,
``combine``), timed whole by the host clock, and ends with
``chip_smoke.h_ntt_check`` (the H(X) stages under the sync check, then
``h_ntt`` and ``upload`` over four more proofs) and the host seconds of the
U/V/W row evaluations alone, best of three: in Python with the limb
packing (what the prover did before it evaluated them natively) and,
where the checkout has ``groth16/solver_native.py``, through it (warm). It
prints the card (``nvidia-smi`` name and power limit) and one JSON line.
"""

import json
import os
import sys
import time

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpu_zkpool_torch import cuda_build, native_bridge  # noqa: E402
from tpu_zkpool_torch.groth16 import prove as tp  # noqa: E402
from tpu_zkpool_torch.msm import kernels  # noqa: E402
from tpu_zkpool_torch.refimpl.groth16_ref import setup, verify  # noqa: E402


def row_times(r1cs, w, reps=3):
    """Best-of-``reps`` host seconds of the three row evaluations: pure
    Python plus ``ints_to_limbs`` and, if importable, the native CSR."""
    import numpy as np
    from tpu_zkpool_torch.fields.limbs import ints_to_limbs
    rows = (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows)
    out = {}

    def python_rows():
        for rs in rows:
            ints_to_limbs([r1cs.eval_row(r, w) for r in rs])

    fns = {"python": python_rows}
    try:
        from tpu_zkpool_torch.groth16 import solver_native as sn
    except ImportError:
        sn = None
    if sn is not None:
        def native_rows():
            w64 = sn.ints_to_u64x4(w)
            for i, rs in enumerate(rows):
                sn.eval_rows_native(("rows", id(r1cs), i), rs, w64)

        native_rows()                        # builds the CSR once
        fns["native"] = native_rows
    for name, fn in fns.items():
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        out[name + "_s"] = best
    return out


def main(argv):
    n = int(argv[argv.index("--proofs") + 1]) if "--proofs" in argv else 5
    if not torch.cuda.is_available():
        print("prove_phases: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    cuda_build.build(kernels.SOURCE)
    native_bridge.get_lib()
    build_s = time.perf_counter() - t0
    r1cs, witness = cs.withdraw_shape_r1cs()
    w = witness(1)
    pk, vk = setup(r1cs, seed=31)
    dpk = tp.DeviceProvingKey(pk, device=device)
    pub = w[1:r1cs.num_public]
    t0 = time.perf_counter()
    proof = tp.prove(dpk, r1cs, w, seed=7)
    cold = time.perf_counter() - t0
    ok = verify(vk, proof, pub)
    warm, phases = [], []
    for i in range(n):
        ph = {}
        t0 = time.perf_counter()
        p = tp.prove(dpk, r1cs, w, seed=8 + i, timings=ph)
        warm.append(time.perf_counter() - t0)
        phases.append(ph)
        ok &= verify(vk, p, pub)
    check = cs.h_ntt_check(dpk, r1cs, w)
    print(json.dumps(dict(root=ROOT, build_s=build_s, cold_s=cold,
                          warm_s=warm, phases_s=phases, h_ntt_check=check,
                          rows=row_times(r1cs, w),
                          seed7=[str(c) for c in proof], verified=bool(ok))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
