#!/usr/bin/env python3
"""Audit-circuit variants on the PyTorch/CUDA port: the port's counterpart
of ``scripts/benchmark_variants.py --device [--logderiv]``.

    python3 scripts/torch_benchmark_variants.py                # four variants
    python3 scripts/torch_benchmark_variants.py --logderiv     # and the two
                                                               # +logderiv
    python3 scripts/torch_benchmark_variants.py --variants var_pk_e_witness
    python3 scripts/torch_benchmark_variants.py --variants none --msm 20,22
    python3 scripts/torch_benchmark_variants.py --device cpu \\
        --variants const_pk_e_witness+logderiv

Each variant ({const, var} PK x {e a witness, e computed}, and with
``--logderiv`` the committed log-derivative forms of the const-PK two) is
built by ``protocol.audit_circuit.build_audit_circuit``, its witness solved
(``witness_committed`` after a committed ``setup`` for the log-derivative
forms) and checked, its keys set up (``groth16.cache.cached_setup``), its
query points put on the device (``DeviceProvingKey``; circuits under 2^17
rows pad every leg to 2^17, as the JAX harness does), then proved once
cold and once warm with another seed through the grid MSM (kernels K1-K6)
and H(X) (kernels P4, P5), and both proofs verified by ``verify_batch``
(kernels P1, P2), which must reject them with one public input changed. A
record keeps each step's seconds, the warm proof's phases, the peak device
memory across the proofs, the host's peak RSS, and K1-K6's, P4's and P5's
launches a proof and P1/P2's in the verify.

``--msm 20,22`` runs the MSM benchmark's inputs (``benchvec``: bases and
scalars from ``random.Random(7)``) at those sizes through ``msm_grid_g1``
(``complete=False``, as ``bench.py`` runs it): the point must equal the
committed one in ``bench_expected.json``, then one cold and three warm
timings, the scalars rolled on the device before each so that every timed
MSM is a different one; and the host input build's seconds, cold and from
its disk cache.

The auditor key comes from ``webui.write_rlwe_dir`` (``rlwe_ref.keygen(42)``)
into ``--out``; the owner is ``tests/vectors.py``'s. Runs on ``cuda`` unless
``--device`` names another device, and raises without a GPU. Writes
``benchmark_variants_torch.json`` (``--json``), whose head holds the card's
``nvidia-smi`` name and power limit; partial runs merge into it.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import torch  # noqa: E402

from tpu_zkpool_torch import benchvec, resolve_device  # noqa: E402
from tpu_zkpool_torch.curve import pairing_kernels as pkern  # noqa: E402
from tpu_zkpool_torch.groth16 import domain  # noqa: E402
from tpu_zkpool_torch.groth16 import ntt_kernels as nkern  # noqa: E402
from tpu_zkpool_torch.groth16 import prove as tp  # noqa: E402
from tpu_zkpool_torch.groth16.cache import cached_setup  # noqa: E402
from tpu_zkpool_torch.groth16.verify import verify_batch  # noqa: E402
from tpu_zkpool_torch.hash.poseidon_params import (  # noqa: E402
    poseidon_hash_ref)
from tpu_zkpool_torch.msm import grid, kernels  # noqa: E402
from tpu_zkpool_torch.msm.grid import TILE_N  # noqa: E402
from tpu_zkpool_torch.protocol.audit_circuit import (  # noqa: E402
    build_audit_circuit, ct_commitment_of)
from tpu_zkpool_torch.refimpl import rlwe_ref  # noqa: E402
from tpu_zkpool_torch.refimpl.groth16_ref import setup  # noqa: E402
from tpu_zkpool_torch.webui import write_rlwe_dir  # noqa: E402

import vectors  # noqa: E402

VARIANTS = ["const_pk_e_witness", "const_pk_e_computed",
            "var_pk_e_witness", "var_pk_e_computed"]
PAD_BELOW = 1 << 17       # circuits under this many rows pad every leg to it
COMMITTED_SEED = 5        # the JAX harness's setup seed for +logderiv
MSM_WARM = 3


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "" without one."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Clock:
    """Seconds of named steps into ``rec`` (the device synchronized at
    both ends of each)."""

    def __init__(self, rec, dev):
        self.rec, self.dev = rec, dev

    def __call__(self, name, fn):
        _sync(self.dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(self.dev)
        self.rec[name] = time.perf_counter() - t0
        return out


def _prover_launches() -> dict:
    """The prover's kernel launches so far: K1-K6 (the MSMs), P4 and P5
    (H(X))."""
    return dict(kernels.LAUNCHES, **nkern.LAUNCHES)


def _moved(before: dict, after: dict) -> dict:
    """Launch counts added between two snapshots of a LAUNCHES dict."""
    return {k: after[k] - before[k] for k in before}


def host_rss_gb() -> float:
    """Peak resident memory of this process so far (GB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def auditor_key(out_dir: str):
    """(a, b) of the auditor's RLWE public key, from a key directory that
    ``webui.write_rlwe_dir`` writes under ``out_dir``."""
    d = write_rlwe_dir(os.path.join(out_dir, "rlwe"))
    with open(os.path.join(d, "rlwe_pk.json")) as f:
        pk = json.load(f)
    return [int(v, 16) for v in pk["a"]], [int(v, 16) for v in pk["b"]]


def pad_for(rows: int) -> int:
    """Every leg's padded size for a circuit of ``rows`` rows: 2^17 under
    2^17 rows (so the const-PK variants and the 2^17 bench MSM share one
    shape, as in the JAX harness), else each leg its own."""
    return PAD_BELOW if rows < PAD_BELOW else 0


def prove_circuit(builder, assignment, publics, *, committed=None,
                  v_challenge=-1, device=None, c=13, lanes=TILE_N,
                  pad_to=None, setup_fn=cached_setup, rec=None):
    """Witness, check, setup, upload, one cold and one warm proof, and the
    verify of a circuit from ``groth16.builder``. ``committed`` (the wires
    of a bsb22 commitment) sets up with ``COMMITTED_SEED`` before the
    witness, which ``witness_committed`` solves; otherwise ``setup_fn``
    sets up after ``builder.witness``. ``publics`` are the public inputs
    ``verify_batch`` takes (without a commitment's hash); the proofs must
    verify, and be rejected with the last one changed. ``pad_to=None``
    pads every leg to 2^17 for a circuit under 2^17 rows. Returns the
    record (``rec``, filled); raises if a check fails."""
    dev = resolve_device(device)
    rec = {} if rec is None else rec
    clock = _Clock(rec, dev)
    r1cs = builder.r1cs()
    rows = len(r1cs.a_rows)
    rec.update(constraints=rows, wires=r1cs.num_vars)
    pk = vk = None
    if committed is not None:
        pk, vk = clock("setup_s", lambda: setup(r1cs, seed=COMMITTED_SEED,
                                                committed=committed))
        rec["committed_wires"] = len(committed)
        w = clock("witness_s", lambda: builder.witness_committed(
            assignment, v_challenge, pk))
    else:
        w = clock("witness_s", lambda: builder.witness(assignment))
    sat = clock("check_s", lambda: r1cs.is_satisfied(w))
    rec["satisfied"] = bool(sat)
    if not sat:
        raise AssertionError("the witness does not satisfy the R1CS")
    if pk is None:
        pk, vk = clock("setup_s", lambda: setup_fn(r1cs))
    rec["n_domain"] = pk.n_domain
    if pad_to is None:
        pad_to = pad_for(rows)
    dpk = clock("device_pk_upload_s", lambda: tp.DeviceProvingKey(
        pk, c=c, lanes=lanes, pad_to=pad_to, device=dev))
    rec.update(c=c, lanes=lanes, pad_to=pad_to,
               leg_points=dict(a=dpk._na, k=dpk._nk, h=dpk._nh,
                               b2=dpk._nb2))
    clock("tables_s", lambda: domain.tables(pk.n_domain, dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cold, warm = {}, {}
    k0 = _prover_launches()
    p_cold = clock("prove_device_cold_s", lambda: tp.prove(
        dpk, r1cs, w, timings=cold))
    k1 = _prover_launches()
    p_warm = clock("prove_device_warm_s", lambda: tp.prove(
        dpk, r1cs, w, seed=11, timings=warm))
    rec["launches_per_proof"] = _moved(k1, _prover_launches())
    rec["launches_cold_proof"] = _moved(k0, k1)
    rec.update(prove_phases_cold=cold, prove_phases_warm=warm)
    if dev.type == "cuda":
        rec["peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    changed = list(publics[:-1]) + [publics[-1] + 1]
    p0 = dict(pkern.LAUNCHES)
    got = clock("verify_s", lambda: verify_batch(
        vk, [p_cold, p_warm, p_cold, p_warm],
        [publics, publics, changed, changed], device=dev))
    rec["verify_launches"] = _moved(p0, pkern.LAUNCHES)
    rec["verify"] = [bool(v) for v in got.tolist()]
    rec["host_rss_gb"] = host_rss_gb()
    if rec["verify"] != [True, True, False, False]:
        raise AssertionError(f"verify_batch gave {rec['verify']}: want both "
                             "proofs accepted and rejected with a changed "
                             "public input")
    return rec


def build_variant(variant: str, a_pk, b_pk):
    """The audit circuit of ``variant`` (``name`` or ``name+logderiv``)
    under the key (a_pk, b_pk), its R1CS made."""
    circ = build_audit_circuit(a_pk, b_pk, variant=variant.split("+")[0],
                               logderiv=variant.endswith("+logderiv"))
    circ.builder.r1cs()
    return circ


def run_variant(variant: str, a_pk, b_pk, *, device=None, c=13,
                lanes=TILE_N, setup_fn=cached_setup, circuit=None,
                log=print):
    """Build, solve, set up, prove and verify one audit-circuit variant
    (``name`` or ``name+logderiv``) for ``tests/vectors.py``'s owner under
    the key (a_pk, b_pk); the record of ``prove_circuit`` with the build's
    seconds. ``circuit``, if given, is the variant's ``build_variant``
    made beforehand (``build_s`` then times nothing)."""
    logderiv = variant.endswith("+logderiv")
    rec = {}
    t0 = time.perf_counter()
    circ = circuit or build_variant(variant, a_pk, b_pk)
    rec["build_s"] = time.perf_counter() - t0
    enc = rlwe_ref.encrypt(a_pk, b_pk, vectors.OWNER_X, vectors.OWNER_Y,
                           seed=999)
    wa = poseidon_hash_ref([vectors.OWNER_X, vectors.OWNER_Y])
    ct = ct_commitment_of(enc)
    assignment = circ.assignment(vectors.OWNER_X, vectors.OWNER_Y, enc, wa,
                                 ct, vectors.SECRET_KEY)
    log(f"  {variant}: {len(circ.builder.r1cs().a_rows)} rows, built in "
        f"{rec['build_s']:.1f} s")
    prove_circuit(circ.builder, assignment, [wa, ct],
                  committed=circ.committed if logderiv else None,
                  v_challenge=circ.v_challenge, device=device, c=c,
                  lanes=lanes, setup_fn=setup_fn, rec=rec)
    return rec


def run_msm(log2n: int, device=None):
    """The bench MSM at 2^log2n (see the module's docstring); raises if its
    point is not the committed one."""
    dev = resolve_device(device)
    rec = {"n": 1 << log2n, "key": benchvec.expected_key(log2n)}
    cached = os.path.exists(os.path.join(
        benchvec._VEC_DIR, f"msm_g1_v{benchvec._VEC_VERSION}_seed"
        f"{benchvec.MSM_SEED}_log{log2n}.npz"))
    clock = _Clock(rec, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    clock("arrays_cached_s" if cached else "arrays_build_s",
          lambda: benchvec.msm_device_arrays(log2n, device=dev))
    X, Y, Z, L = clock("arrays_cached_s", lambda: benchvec.msm_device_arrays(
        log2n, device=dev))
    k0 = dict(kernels.LAUNCHES)
    out = clock("cold_s", lambda: grid.msm_grid_g1((X, Y, Z), L,
                                                   complete=False))
    rec["launches"] = _moved(k0, kernels.LAUNCHES)
    got = tp._g1_affine(tuple(t.cpu() for t in out))
    want = benchvec.load_expected(log2n)
    rec["equal_to_committed"] = want is not None and got == want
    if not rec["equal_to_committed"]:
        raise AssertionError(f"the 2^{log2n} MSM gave {got}, the committed "
                             f"point is {want}")
    rec["warm_ms"] = []
    for s in range(1, MSM_WARM + 1):
        Ls = torch.roll(L, s, 0)
        t = {}
        _Clock(t, dev)("s", lambda: grid.msm_grid_g1((X, Y, Z), Ls,
                                                     complete=False))
        rec["warm_ms"].append(t["s"] * 1e3)
    if dev.type == "cuda":
        rec["peak_device_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return rec


def merge(path: str, payload: dict) -> dict:
    """Merge this run's results and MSMs into the file at ``path``."""
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        for key in ("results", "msm"):
            old.setdefault(key, {}).update(payload.get(key, {}))
        old.update({k: v for k, v in payload.items()
                    if k not in ("results", "msm")})
        payload = old
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, or 'none'")
    ap.add_argument("--logderiv", action="store_true",
                    help="add the +logderiv form of each const-PK variant")
    ap.add_argument("--msm", default="", help="bench MSM sizes, e.g. 20,22")
    ap.add_argument("--device", default=None, help="default cuda")
    ap.add_argument("--out", default=os.path.join(_ROOT, "variants_out"),
                    help="scratch directory (the auditor key)")
    ap.add_argument("--json", default=os.path.join(
        _ROOT, "benchmark_variants_torch.json"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = [v for v in args.variants.split(",") if v and v != "none"]
    if args.logderiv:
        names += [v + "+logderiv" for v in names if v.startswith("const_pk")]
    a_pk, b_pk = auditor_key(args.out) if names else (None, None)
    head = dict(harness="scripts/torch_benchmark_variants.py",
                reference="scripts/benchmark_variants.py", card=card(),
                torch=torch.__version__, cuda=torch.version.cuda,
                device=str(dev), host_cpus=os.cpu_count())
    for name in names:
        print(f"=== {name} ===", flush=True)
        rec = run_variant(name, a_pk, b_pk, device=dev)
        print("  " + json.dumps(rec), flush=True)
        merge(args.json, dict(head, results={name: rec}))
    for log2n in [int(v) for v in args.msm.split(",") if v]:
        print(f"=== msm 2^{log2n} ===", flush=True)
        rec = run_msm(log2n, device=dev)
        print("  " + json.dumps(rec), flush=True)
        merge(args.json, dict(head, msm={str(log2n): rec}))
    print(head["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
