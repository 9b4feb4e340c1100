"""Port parity across processes: two worker processes over Gloo on the CPU.

The form of ``tests/test_multihost.py``: a real two-process
``torch.distributed`` runtime (``multihost.initialize`` on a free local
port), a (2 hosts x 2 chips) ``pod_mesh(device="cpu", chips=2)`` whose host
axis is the process boundary, and in it ``hierarchical_fold`` (its level-2
gather crosses the processes), both sharded MSMs and the sharded Merkle
root; then the sharded negacyclic NTT on ``span_mesh`` meshes whose one
axis crosses the processes, D = 2 (one slot a process: every cross stage
crosses) and D = 4 (two a process: one crossing stage, one local), under
``exchange="ppermute"`` (``Mesh.ppermute`` over Gloo). The workers import
only the port and print or save their results; the parent holds them to
the native Pippenger oracle, the JAX tree's host root and JAX's
single-device ``rlwe.ntt`` (exactly), at ``tests/test_torch_parallel.py``'s
and ``tests/test_torch_ntt_sharded.py``'s small sizes (the workers run the
kernels' plain twins). Each worker is bounded by its own timeout.
"""

import datetime
import json
import os
import random
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool import native_bridge as jnb
from tpu_zkpool.merkle import MerkleTree as JaxTree
from tpu_zkpool.rlwe import ntt as jn

from tpu_zkpool_torch.fields.fctx import FP, FR
from tpu_zkpool_torch.fields.limbs import ints_to_limbs
from tpu_zkpool_torch.parallel import multihost

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

C, NBITS, LANES = 5, 20, 32     # as tests/test_torch_parallel.py
N_POINTS = 2 * LANES * 4        # two lane tiles on each of the 4 slots
N_LEAVES, DEPTH = 8, 5
NTT_N, NTT_B, NTT_DS = 1024, 5, (2, 4)   # ring, an odd batch, shard counts
Q = 167772161

_WORKER = r"""
import datetime, json, os, sys
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
pid, port, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]

from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.groth16 import prove as tp
from tpu_zkpool_torch.parallel import (initialize, msm_grid_sharded,
                                       pod_mesh, process_count,
                                       process_index)
from tpu_zkpool_torch.parallel.merkle_sharded import root_sharded
from tpu_zkpool_torch.parallel.msm_sharded import msm_grid_sharded_2d
from tpu_zkpool_torch.parallel.multihost import hierarchical_fold

assert initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid,
                  backend="gloo", timeout=datetime.timedelta(seconds=120))
assert (process_count(), process_index()) == (2, pid)
mesh = pod_mesh(device="cpu", chips=2)
assert mesh.shape == {"host": 2, "chip": 2}
assert [s.process for s in mesh.slots] == [0, 0, 1, 1]
assert [s.local for s in mesh.slots] == [pid == 0] * 2 + [pid == 1] * 2
spec = (("host", "chip"),)

# each slot's partial of arange(16), then the two-level fold
x = torch.arange(16.)
parts = [None if p is None else p.sum() for p in mesh.shard(x, spec)]
fold = float(mesh.join(hierarchical_fold(lambda a, b: a + b, parts, mesh),
                       "cpu"))

def load(name):
    return torch.from_numpy(np.load(os.path.join(d, name + ".npy")))

def affine(row):
    p = tp._g1_affine(tuple(row[i, 0] for i in range(3)))
    return None if p is None else [str(v) for v in p]

rows, limbs = load("rows"), load("limbs")
kw = dict(c=%(c)d, lanes=%(lanes)d, nbits=%(nbits)d)
msm2d = msm_grid_sharded_2d(rows, limbs, mesh, **kw)
msm1d = msm_grid_sharded(rows, limbs, mesh, axis=("host", "chip"), **kw)
root = root_sharded(load("leaves"), mesh, axis=("host", "chip"),
                    depth=%(depth)d)

# the sharded NTT over one axis that crosses the processes
from tpu_zkpool_torch.parallel import (forward_sharded, inverse_sharded,
                                       negacyclic_mul_sharded, span_mesh)
a, b = load("ntt_a"), load("ntt_b")
refusals = {}
for D in load("ntt_ds").tolist():
    m = span_mesh(device="cpu", chips=D // 2)
    assert m.crossing("sp") and [s.local for s in m.slots] == (
        [pid == 0] * (D // 2) + [pid == 1] * (D // 2))
    f = forward_sharded(a, m, exchange="ppermute")
    outs = dict(forward=f, inverse=inverse_sharded(f, m,
                                                   exchange="ppermute"),
                mul=negacyclic_mul_sharded(a, b, m, exchange="ppermute"))
    for name, t in outs.items():
        np.save(os.path.join(d, f"ntt{pid}_D{D}_{name}.npy"), t.numpy())
    for what, fn in (
            ("rdma", lambda: negacyclic_mul_sharded(a, b, m,
                                                    exchange="rdma")),
            ("graphed", lambda: m.graphed("k", lambda t: t, a))):
        try:
            fn()
            refusals[f"{what} D={D}"] = None
        except ValueError as e:
            refusals[f"{what} D={D}"] = str(e)

print("RESULT " + json.dumps(dict(
    fold=fold, msm2d=affine(msm2d), msm1d=affine(msm1d),
    root=str(int(FR.from_mont(root))), refusals=refusals)), flush=True)
torch.distributed.destroy_process_group()
print(f"WORKER{pid}_OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _msm_inputs(n, seed):
    """n affine G1 points (one identity) as Jacobian rows (n, 3, 1, 16),
    scalars < 2^(NBITS-1) as limbs, and the oracle's affine point."""
    rng = random.Random(seed)
    pts = jnb.g1_gen_mul_batch([rng.randrange(1, 1 << 62) for _ in range(n)])
    ks = [rng.randrange(1 << (NBITS - 1)) for _ in range(n)]
    rows = [[[x], [y], [1]] for x, y in pts]
    rows[3] = [[0], [0], [0]]                        # the identity
    want = jnb.g1_msm([k for i, k in enumerate(ks) if i != 3],
                      [p for i, p in enumerate(pts) if i != 3])
    return (np.asarray(FP.to_mont(rows), dtype=np.int64),
            np.asarray(ints_to_limbs(ks), dtype=np.int64), want)


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Run the two workers once; their results and the oracles."""
    d = tmp_path_factory.mktemp("pod")
    rows, limbs, want = _msm_inputs(N_POINTS, 81)
    rng = random.Random(82)
    leaves = [rng.randrange(FR.modulus) for _ in range(N_LEAVES)]
    np.save(d / "rows.npy", rows)
    np.save(d / "limbs.npy", limbs)
    np.save(d / "leaves.npy", np.asarray(
        FR.to_mont(np.asarray(leaves, dtype=object)), dtype=np.int64))
    jt = JaxTree(depth=DEPTH)
    for v in leaves:
        jt.insert(v)
    ntt_rng = np.random.default_rng(83)
    a, b = (ntt_rng.integers(0, Q, (NTT_B, NTT_N), dtype=np.uint32)
            for _ in range(2))
    a[0, :3] = [0, 1, Q - 1]
    np.save(d / "ntt_a.npy", a.astype(np.int32))
    np.save(d / "ntt_b.npy", b.astype(np.int32))
    np.save(d / "ntt_ds.npy", np.asarray(NTT_DS))
    script = d / "worker.py"
    script.write_text(_WORKER % dict(repo=_REPO, c=C, lanes=LANES,
                                     nbits=NBITS, depth=DEPTH))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in multihost.LAUNCHER_ENV + ("LOCAL_RANK",)}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"WORKER{pid}_OK" in out
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res = json.loads(line[-1][len("RESULT "):])
        res["ntt"] = {(D, name): np.load(d / f"ntt{pid}_D{D}_{name}.npy")
                      for D in NTT_DS
                      for name in ("forward", "inverse", "mul")}
        results.append(res)
    ntt = dict(inverse=a,
               forward=np.asarray(jax.jit(jn.forward)(jnp.asarray(a))),
               mul=np.asarray(jax.jit(jn.negacyclic_mul)(jnp.asarray(a),
                                                        jnp.asarray(b))))
    return results, dict(msm=[str(v) for v in want], root=str(jt.get_root()),
                         ntt=ntt)


def test_pod_hierarchical_fold(pod):
    results, _ = pod
    assert [r["fold"] for r in results] == [120.0, 120.0]


@pytest.mark.parametrize("form", ["msm2d", "msm1d"])
def test_pod_msm_vs_native(pod, form):
    """msm_grid_sharded_2d (chip fold, then one partial a process) and
    msm_grid_sharded over the flattened (host, chip) axis: both processes
    return the oracle's point."""
    results, want = pod
    assert [r[form] for r in results] == [want["msm"]] * 2


def test_pod_root_sharded_matches_jax_tree(pod):
    results, want = pod
    assert [r["root"] for r in results] == [want["root"]] * 2


@pytest.mark.parametrize("form", ["forward", "inverse", "mul"])
@pytest.mark.parametrize("D", NTT_DS)
def test_pod_ntt_sharded_matches_jax(pod, D, form):
    """The sharded NTT with its ``sp`` axis across the two processes,
    ``exchange="ppermute"``: in both processes the forward equals JAX's
    ``rlwe.ntt.forward``, the inverse of it gives back the input, and the
    product equals JAX's ``rlwe.ntt.negacyclic_mul``, word for word."""
    results, want = pod
    for r in results:
        got = r["ntt"][D, form].astype(np.uint32)
        assert got.shape == (NTT_B, NTT_N)
        assert (got == want["ntt"][form]).all()


def test_pod_ntt_refuses_rdma_and_graphed_on_cpu(pod):
    """Across CPU processes K9's partner read raises a ValueError (it maps
    the partner's shard by CUDA IPC; the CPU has no shared device memory),
    and ``Mesh.graphed`` still raises on the crossing mesh, in both."""
    results, _ = pod
    for r in results:
        for D in NTT_DS:
            assert "CUDA IPC" in (r["refusals"][f"rdma D={D}"] or "")
            assert "graphed over axis ('sp',): the axis crosses" in (
                r["refusals"][f"graphed D={D}"] or "")


def test_initialize_without_runtime_returns_false(monkeypatch):
    for k in multihost.LAUNCHER_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="partial"):
        multihost.initialize()


def test_initialize_raises_on_unreachable_coordinator():
    """JAX's initialize swallows a failed start; the port's raises."""
    with pytest.raises(RuntimeError):
        multihost.initialize(f"127.0.0.1:{_free_port()}", num_processes=2,
                             process_id=1, backend="gloo",
                             timeout=datetime.timedelta(seconds=2))
    assert multihost.process_count() == 1
