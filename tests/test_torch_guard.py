"""Guards of the PyTorch port: it imports neither ``jax`` nor anything of
``tpu_zkpool``, its entry points never fall back to the CPU unasked, and its
CUDA constants are BN254's."""

import ast
import os
import re

import pytest
import torch

from tpu_zkpool_torch.fields.fctx import FP, FR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_zkpool_torch")


SCRIPTS = ["chip_smoke.py", os.path.join("scripts", "withdraw_acir.py"),
           os.path.join("examples", "torch_withdraw_e2e.py"),
           os.path.join("examples", "torch_demo_cli.py"),
           os.path.join("examples", "torch_audit_e2e.py"),
           os.path.join("scripts", "withdraw_phase13.py"),
           os.path.join("scripts", "pod_phase14.py"),
           os.path.join("scripts", "pod_nccl_probe.py"),
           os.path.join("scripts", "pod_ipc_probe.py"),
           os.path.join("scripts", "torch_benchmark_variants.py"),
           os.path.join("scripts", "fr_ntt_phase2.py"),
           os.path.join("scripts", "fr_ntt_transforms.py"),
           os.path.join("scripts", "chip_smoke_profile.py"),
           os.path.join("scripts", "launch_count_probe.py"),
           os.path.join("scripts", "span_cost.py"),
           os.path.join("scripts", "trace_cost.py")]


def _port_sources():
    """The port's scripts and every module of the port, found by walking
    it."""
    for f in SCRIPTS:
        yield os.path.join(ROOT, f)
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = list(_port_sources())
    assert len(files) > 10
    names = {os.path.relpath(f, PKG) for f in files}
    assert {"cuda_build.py", os.path.join("hash", "poseidon.py"),
            os.path.join("hash", "kernels.py"),
            os.path.join("merkle", "tree.py"),
            os.path.join("msm", "affine_tree.py"),
            os.path.join("msm", "tree_kernels.py"),
            os.path.join("fields", "rlweq.py"), os.path.join("rlwe", "ntt.py"),
            os.path.join("refimpl", "rlwe_ref.py"),
            os.path.join("groth16", "solver_native.py"),
            os.path.join("groth16", "verify.py"),
            os.path.join("groth16", "builder.py"),
            os.path.join("groth16", "gadgets.py"),
            os.path.join("hash", "poseidon2.py"),
            os.path.join("hash", "poseidon2_kernels.py"),
            os.path.join("groth16", "domain.py"),
            os.path.join("groth16", "ntt_kernels.py"),
            os.path.join("refimpl", "curve_ref.py"),
            os.path.join("rlwe", "encrypt.py"),
            os.path.join("rlwe", "quotient.py"),
            os.path.join("shamir", "__init__.py"),
            os.path.join("shamir", "shamir.py"),
            os.path.join("protocol", "__init__.py"),
            os.path.join("protocol", "audit_circuit.py")} | {
                os.path.join("curve", f) for f in (
                    "__init__.py", "tower.py", "lines.py", "pairing.py",
                    "pairing_kernels.py")} | {
                os.path.join("parallel", f) for f in (
                    "__init__.py", "mesh.py", "ntt_rdma.py", "ntt_sharded.py",
                    "msm_sharded.py", "multihost.py", "prove_stages.py",
                    "merkle_sharded.py")} | {
                "config.py",
                os.path.join("curve", "weierstrass.py"),
                os.path.join("curve", "fixed_base.py"),
                os.path.join("groth16", "gnark_fmt.py"),
                os.path.join("groth16", "cache.py")} | {
                os.path.join("protocol", f) for f in (
                    "state.py", "errors.py", "relayer.py", "storage.py",
                    "proof_hex.py", "flows.py")} | {
                os.path.join("utils", f) for f in (
                    "__init__.py", "metrics.py", "profiling.py")} | {
                os.path.join("webui", f) for f in (
                    "__init__.py", "__main__.py", "app.py",
                    "server.py")} | {
                "benchvec.py"} | {
                os.path.join("groth16", f) for f in (
                    "acir.py", "solver.py", "r1cs.py", "ccs.py",
                    "ccs_solve.py")} <= names
    for path in files:
        for mod in _imported(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpu_zkpool"), (path, mod)


def test_pod_worker_imports_only_the_port():
    """The two-process test's worker script (the string the parent writes
    out) imports the port and nothing of JAX."""
    path = os.path.join(ROOT, "tests", "test_torch_multihost.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    src = next(node.value.value for node in tree.body
               if isinstance(node, ast.Assign)
               and getattr(node.targets[0], "id", None) == "_WORKER")
    worker = ast.parse(src % dict(repo=ROOT, c=5, lanes=32, nbits=20,
                                  depth=5))
    mods = {a.name for n in ast.walk(worker) if isinstance(n, ast.Import)
            for a in n.names} | {n.module for n in ast.walk(worker)
                                 if isinstance(n, ast.ImportFrom)}
    assert "tpu_zkpool_torch.parallel" in mods
    assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib",
                                                  "tpu_zkpool"}


def test_entry_points_raise_without_cuda(monkeypatch):
    from tpu_zkpool_torch import resolve_device
    from tpu_zkpool_torch.groth16 import prove as tp
    from tpu_zkpool_torch.refimpl.groth16_ref import R1CS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    r1cs = R1CS(num_vars=2, num_public=1, a_rows=[{1: 1}], b_rows=[{0: 1}],
                c_rows=[{1: 1}])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.compute_h_device(r1cs, [1, 2], 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.DeviceProvingKey(None)
    assert resolve_device("cpu").type == "cpu"


def test_hash_and_merkle_entry_points_raise_without_cuda(monkeypatch):
    from tpu_zkpool_torch.hash import poseidon
    from tpu_zkpool_torch.merkle import MerkleTree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = poseidon._mont_tables(3)
    for call in (MerkleTree, lambda: poseidon.hash_ints([1], [2]),
                 lambda: poseidon.load_tables(arrays)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert MerkleTree(device="cpu").device.type == "cpu"
    assert list(poseidon.hash_ints([1], [2], device="cpu")) == [
        7853200120776062878684798364095072458815029376092732009249414926327459813530]
    assert poseidon.load_tables(arrays, device="cpu").m.device.type == "cpu"


def test_cuda_field_constants_are_bn254():
    with open(os.path.join(PKG, "csrc", "field.cuh")) as f:
        src = f.read()

    def words(name):
        body = re.search(r"\b" + name + r"\[8\] = \{([^}]*)\}", src).group(1)
        ws = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(w << (32 * i) for i, w in enumerate(ws))

    def n0(name):
        return int(re.search(r"\b" + name + r" = (0x[0-9a-f]+)u", src).group(1),
                   16)

    assert words("kP") == FP.modulus
    assert words("kR1") == FP.r_mod_p
    assert n0("kN0") == FP.n0_32 == (-pow(FP.modulus, -1, 1 << 32)) % (1 << 32)
    assert words("kFrP") == FR.modulus
    assert words("kFrR1") == FR.r_mod_p
    assert n0("kFrN0") == FR.n0_32 == 0xefffffff


def test_kernel_wrappers_reject_bad_inputs():
    from tpu_zkpool_torch.msm import kernels
    meta = torch.empty((4, 3, 1, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.addn(meta, meta)


def test_tree_level_wrapper_rejects_bad_inputs():
    from tpu_zkpool_torch.msm import tree_kernels
    rows = torch.empty((4, 32), dtype=torch.int64, device="meta")
    fl = torch.empty((4,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tree_kernels.tree_level(rows, rows, fl, True)


def test_poseidon_wrapper_rejects_bad_inputs():
    from tpu_zkpool_torch.hash import kernels, poseidon
    meta = torch.empty((4, 2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hash_tiles(meta, 3)
    # K7 is built for every width t = 2 .. 17: t = 2 and t = 6 pass the
    # width check and stop at the device check; t = 18 has no parameters
    assert kernels.WIDTHS == tuple(range(2, 18))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hash_tiles(meta[:, :1], 2)
    # a width that does not match the rows raises on the CPU as on the card
    with pytest.raises(ValueError, match=r"want \(B, 4, 16\)"):
        kernels.hash_tiles(torch.zeros((4, 2, 16), dtype=torch.int64), 5)
    with pytest.raises(ValueError, match="CUDA"):
        poseidon.hash_n(torch.empty((4, 5, 16), dtype=torch.int64,
                                    device="meta"))
    with pytest.raises(ValueError, match="not t = 18"):
        poseidon.hash_n(torch.empty((4, 17, 16), dtype=torch.int64,
                                    device="meta"))


def test_rlweq_from_numpy_asks_for_cuda(monkeypatch):
    from tpu_zkpool_torch.fields import rlweq
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = [0, 1, rlweq.Q - 1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rlweq.from_numpy_u32(a)
    t = rlweq.from_numpy_u32(a, device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.int32
    assert t.tolist() == a


def test_mesh_and_sharded_ntt_raise_without_cuda(monkeypatch):
    from tpu_zkpool_torch.parallel import Mesh, negacyclic_mul_sharded
    from tpu_zkpool_torch.parallel.multihost import pod_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh.virtual((2,), ("sp",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pod_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mesh([["cuda:0", "cuda:0"]], ("host", "chip"))
    a = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        negacyclic_mul_sharded(a, a, Mesh.virtual((2,), ("sp",)))
    mesh = Mesh.virtual((2,), ("sp",), device="cpu")
    assert [s.device.type for s in mesh.slots] == ["cpu", "cpu"]
    assert [s.stream for s in mesh.slots] == [None, None]
    assert negacyclic_mul_sharded(a, a, mesh).device.type == "cpu"


def _fake_runtime(monkeypatch, rank, cuda):
    """torch.distributed as a 2-process runtime seen from ``rank``, and
    ``cuda`` CUDA devices, without starting anything."""
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cuda)
    monkeypatch.delenv("LOCAL_RANK", raising=False)


def test_pod_mesh_asks_for_its_own_card(monkeypatch):
    """In a multi-process run ``pod_mesh()`` takes cuda:LOCAL_RANK: it
    raises without CUDA, and raises rather than wrap rank 1 onto the one
    card of a machine."""
    from tpu_zkpool_torch.parallel.multihost import pod_mesh
    _fake_runtime(monkeypatch, 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pod_mesh()
    _fake_runtime(monkeypatch, 1, 1)
    with pytest.raises(ValueError, match="cuda:1"):
        pod_mesh()


def test_cross_process_axis_refuses_ppermute_graphed_and_k9():
    """On a (host, chip) mesh whose host axis is the process boundary,
    ``graphed`` raises a ValueError naming the axis (a CUDA graph holds one
    process's work); K9's partner read across processes on CPU slots
    raises a ValueError (it maps the partner's shard by CUDA IPC, and the
    CPU has no shared device memory), and so does the sharded NTT under
    ``exchange="rdma"``; ``ppermute`` across processes refuses to run
    without the ``torch.distributed`` runtime it exchanges through
    (``tests/test_torch_multihost.py`` runs it with one); within a process
    ``ppermute`` still runs."""
    import numpy as np
    from tpu_zkpool_torch.parallel import Mesh, ntt_rdma, forward_sharded
    grid = np.full((2, 2), "cpu", dtype=object)
    mesh = Mesh(grid, ("host", "chip"), processes=[[0, 0], [1, 1]])
    assert [s.local for s in mesh.slots] == [True, True, False, False]
    assert [s.device for s in mesh.slots[2:]] == [None, None]
    assert mesh.crossing("host") and not mesh.crossing("chip")
    vals = [torch.full((2,), float(i)) for i in range(2)] + [None, None]
    across = [mesh.partner(s, "host", 1).index for s in mesh.slots]
    within = [mesh.partner(s, "chip", 1).index for s in mesh.slots]
    with pytest.raises(RuntimeError, match="torch.distributed"):
        mesh.ppermute(vals, across)
    out = mesh.ppermute(vals, within)
    assert [float(t[0]) for t in out[:2]] == [1.0, 0.0] and out[2:] == [
        None, None]
    with pytest.raises(ValueError, match="graphed over axis.*'host'"):
        mesh.graphed("k", lambda t: t, torch.zeros(2))
    with pytest.raises(ValueError, match="CUDA IPC.*exchange='ppermute'"):
        forward_sharded(torch.zeros((1, 8), dtype=torch.int32), mesh,
                        axis="host", exchange="rdma")
    with pytest.raises(ValueError, match="CUDA IPC"):
        ntt_rdma.exchange_butterfly(mesh, vals, vals, [True] * 4, across)
    assert mesh.shard(torch.arange(4.), (("host", "chip"),))[2:] == [
        None, None]


@pytest.mark.parametrize("rank", [0, 1])
def test_routes_pair_sends_with_receives(monkeypatch, rank):
    """``Mesh.routes`` on a 1-D axis of 8 slots over two processes (four
    each), partners d ^ 4 and then d ^ 1: at hd = 4 every slot sends to
    and takes from the other process, each list in the taking slot's
    order, so what one process sends is what the other expects; at hd = 1
    nothing crosses."""
    import numpy as np
    from tpu_zkpool_torch.parallel import Mesh
    _fake_runtime(monkeypatch, rank, 0)
    owner = np.repeat([0, 1], 4)
    mesh = Mesh(np.full(8, "cpu", dtype=object), ("sp",), processes=owner)
    far = [mesh.partner(s, "sp", 4).index for s in mesh.slots]
    mine = [i for i in range(8) if owner[i] == rank]
    assert mesh.routes(far) == {1 - rank: (mine, mine)}
    assert mesh.routes([mesh.partner(s, "sp", 1).index
                        for s in mesh.slots]) == {}
    # a permutation that is not an involution: slot t takes slot t + 1
    shift = [(i + 1) % 8 for i in range(8)]
    want = ([4], [7]) if rank else ([0], [3])
    assert mesh.routes(shift) == {1 - rank: want}


def test_exchange_butterfly_wrapper_rejects_bad_inputs():
    from tpu_zkpool_torch.parallel import ntt_rdma
    y = torch.empty((4, 8), dtype=torch.int32, device="meta")
    tw = torch.empty((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ntt_rdma.butterfly(y, y, tw, 0)
    # int64 words are refused on the CPU as on the card
    y64 = torch.zeros((4, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        ntt_rdma.butterfly(y64, y64, torch.zeros(8, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match=r"\(rows, S\)"):
        ntt_rdma.butterfly(y[0], y[0], tw, 0)


def _stage_case(case):
    y = torch.zeros((4, 8), dtype=torch.int32)
    tw = torch.zeros((8,), dtype=torch.int32)
    n = 1
    if case == "slots":
        n = 33
    ys, others, tws = [y] * n, [y] * n, [tw] * n
    if case == "shapes":
        ys, others, tws = [y, y[:3]], [y, y[:3]], [tw, tw]
    elif case == "contiguous":
        sq = torch.zeros((8, 8), dtype=torch.int32).t()
        ys, others = [sq], [sq]
    elif case == "int32":
        ys = [y.long()]
    return ys, others, tws


@pytest.mark.parametrize("case,match", [
    ("slots", "1 to 32 slots"), ("shapes", "alike over the slots"),
    ("contiguous", "contiguous"), ("int32", "int32")])
def test_exchange_stage_rejects_bad_inputs(case, match):
    """K9's all-slot stage refuses, on either device type, more slots than
    its parameter struct holds, shards that differ in shape, non-contiguous
    and non-int32 tensors."""
    from tpu_zkpool_torch.parallel import ntt_rdma
    ys, others, tws = _stage_case(case)
    with pytest.raises(ValueError, match=match):
        ntt_rdma.stage(ys, others, tws, [True] * len(ys))
    meta = [[t.to("meta") for t in ts] for ts in (ys, others, tws)]
    with pytest.raises(ValueError, match=match):
        ntt_rdma.stage(*meta, [True] * len(ys))


def test_verify_and_lines_ask_for_cuda(monkeypatch):
    from tpu_zkpool_torch.curve import lines
    from tpu_zkpool_torch.groth16 import verify as tv
    from tpu_zkpool_torch.refimpl import pairing_ref as pr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = pr.G2_GEN
    for call in (lambda: lines.precompute_g2_lines(q),
                 lambda: lines.precompute_g2_lines_batch([q, q]),
                 lambda: tv.verify_batch(None, [], [])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    lg = lines.precompute_g2_lines(q, device="cpu")
    assert lg.dbl_an0.device.type == "cpu" and lg.dbl_an0.shape == (64, 16)


def _meta_leg(shape_dbl, shape_end):
    from tpu_zkpool_torch.curve.lines import LineArrays
    return LineArrays(*[torch.empty(shape_dbl if k < 8 else shape_end,
                                    dtype=torch.int64, device="meta")
                        for k in range(12)])


def test_pairing_wrappers_reject_bad_inputs():
    """P1 and P2 check shapes and dtypes before the device: on meta tensors
    a good call stops at the CUDA check, a bad one at its shape."""
    from tpu_zkpool_torch.curve import pairing_kernels as pk
    B = 4
    pt = torch.empty((B, 16), dtype=torch.int64, device="meta")
    fixed, batched = _meta_leg((64, 16), (2, 16)), _meta_leg((64, B, 16),
                                                             (2, B, 16))
    with pytest.raises(ValueError, match="CUDA"):
        pk.miller_lines([(pt, pt)] * 3, [batched, fixed, fixed])
    with pytest.raises(ValueError, match="1 to 3 legs"):
        pk.miller_lines([(pt, pt)] * 4, [fixed] * 4)
    with pytest.raises(ValueError, match="batch"):
        pk.miller_lines([(pt, pt)], [_meta_leg((64, 3, 16), (2, 3, 16))])
    with pytest.raises(ValueError, match="line array 8"):
        pk.miller_lines([(pt, pt)], [_meta_leg((64, 16), (3, 16))])
    with pytest.raises(ValueError, match=r"\(B, 16\)"):
        pk.miller_lines([(pt[:2], pt)], [fixed])
    with pytest.raises(ValueError, match="int64"):
        pk.miller_lines([(pt.int(), pt.int())], [fixed])
    f = torch.empty((B, 12, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pk.final_exp(f)
    with pytest.raises(ValueError, match=r"\(B, 12, 16\)"):
        pk.final_exp(f.view(B, 6, 2, 16))
    with pytest.raises(ValueError, match="int64"):
        pk.final_exp(torch.zeros((B, 12, 16), dtype=torch.int32))


def test_tower_constructors_ask_for_cuda(monkeypatch):
    """The Fp2 / Fp12 constructors run on ``cuda`` unless a device is
    named, and raise without a GPU instead of landing on the CPU."""
    from tpu_zkpool_torch.curve import tower as tw
    from tpu_zkpool_torch.refimpl import pairing_ref as pr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"f2_zero": lambda **k: tw.f2_zero((2,), **k),
             "f2_one": lambda **k: tw.f2_one((2,), **k),
             "f12_one": lambda **k: tw.f12_one((), **k),
             "f12_from_ints": lambda **k: tw.f12_from_ints([pr.F12_ONE], **k),
             "f2_const": lambda **k: tw.f2_const((1, 2), **k)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        assert call(device="cpu").device.type == "cpu", name


def test_poseidon2_wrappers_reject_bad_inputs():
    """P3's wrappers check shapes and dtypes before the device: on meta
    tensors a good call stops at the CUDA check, a bad one at its shape."""
    from tpu_zkpool_torch.hash import poseidon2, poseidon2_kernels as p2k
    meta = torch.empty((4, 4, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        p2k.permute(meta)
    with pytest.raises(ValueError, match="CUDA"):
        p2k.sponge(torch.empty((4, 157, 16), dtype=torch.int64,
                               device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        poseidon2.ct_commitment(meta)
    with pytest.raises(ValueError, match=r"\(B, 4, 16\)"):
        p2k.permute(meta[:, :3])
    with pytest.raises(ValueError, match="int64"):
        p2k.sponge(meta.int())


def test_fr_ntt_wrappers_reject_bad_inputs():
    """P4's and P5's wrappers check shapes and dtypes before the device: on
    meta tensors a good call stops at the CUDA check, a bad one at its
    shape or dtype; the domain functions on a tensor off the CPU take the
    kernel route and raise there rather than run the plain forms."""
    import numpy as np
    from tpu_zkpool_torch.groth16 import domain, ntt_kernels as nk
    from tpu_zkpool_torch.groth16 import prove as tp
    meta = torch.empty((3, 8, 16), dtype=torch.int64, device="meta")
    pw = torch.empty((4, 8), dtype=torch.int32, device="meta")
    tab = torch.empty((8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        nk.fr_pass(meta, pw, 2, 2, True)
    with pytest.raises(ValueError, match="CUDA"):
        nk.fr_pass(meta, pw, 1, 3, False, pre=tab, post=tab,
                   post_scalar=meta[0, 0], quotient=(meta, meta, meta[0, 0]))
    with pytest.raises(ValueError, match="CUDA"):
        nk.pointwise(meta, meta[0, 0], out=meta)
    for fn in ("forward", "inverse", "interpolate_natural", "coset_forward",
               "coset_inverse"):
        with pytest.raises(ValueError, match="CUDA"):
            getattr(domain, fn)(meta)
    with pytest.raises(ValueError, match="CUDA"):
        tp._unpack_mont_fr(np.zeros((3, 8, 8), np.uint32), "meta")
    bad = [(lambda: nk.fr_pass(meta[..., :8], pw, 2, 1, True),
            r"\(\.\.\., 16\)"),
           (lambda: nk.fr_pass(meta[:, :6], pw, 2, 1, True), "power of two"),
           (lambda: nk.fr_pass(meta, pw, 8, 1, True), "does not fit"),
           (lambda: nk.fr_pass(meta, pw, 2, 3, True), "does not fit"),
           (lambda: nk.fr_pass(meta, pw, 2, 3, False), "does not fit"),
           (lambda: nk.fr_pass(meta, pw, 3, 1, False), "does not fit"),
           (lambda: nk.fr_pass(meta, pw, 1, 0, True), "count"),
           (lambda: nk.fr_pass(meta, pw, 1, 12, True), "does not fit"),
           (lambda: nk.fr_pass(meta, pw[:2], 2, 1, True), "power table"),
           (lambda: nk.fr_pass(meta, pw.long(), 2, 1, True), "int32"),
           (lambda: nk.fr_pass(meta, pw, 2, 1, True, pre=pw), "pre"),
           (lambda: nk.fr_pass(meta, pw, 2, 1, True, post=meta[0]), "post"),
           (lambda: nk.fr_pass(meta.int(), pw, 2, 1, True), "int64"),
           (lambda: nk.fr_pass(meta, pw, 1, 1, False,
                               quotient=(meta, meta[:2], meta[0, 0])),
            "quotient's c"),
           (lambda: nk.fr_pass(meta, pw, 1, 1, False, bitrev=True, out=meta),
            "out of place"),
           (lambda: nk.pointwise(meta, meta[0, :5]), "t must"),
           (lambda: nk.pointwise(meta, meta[0, 0], out=meta[:2]),
            "out must"),
           (lambda: nk.pointwise(meta, meta[0, 0].int()), "int64")]
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()


def test_from_jax_asks_for_cuda(monkeypatch):
    import numpy as np
    from tpu_zkpool_torch.fields.limbs import from_jax
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    limbs = np.arange(32, dtype=np.uint32).reshape(2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax(limbs)
    t = from_jax(limbs, device="cpu")
    assert t.dtype == torch.int64 and t.tolist() == limbs.tolist()
    with pytest.raises(ValueError, match="16"):
        from_jax(limbs[:, :8], device="cpu")
