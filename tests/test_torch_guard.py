"""Guards of the PyTorch port: it imports neither ``jax`` nor anything of
``tpu_zkpool``, its entry points never fall back to the CPU unasked, and its
CUDA constants are BN254's."""

import ast
import os
import re

import pytest
import torch

from tpu_zkpool_torch.fields.fctx import FP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_zkpool_torch")


def _port_sources():
    yield os.path.join(ROOT, "chip_smoke.py")
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
    for path in files:
        for mod in _imported(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpu_zkpool"), (path, mod)


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


def test_cuda_field_constants_are_bn254():
    with open(os.path.join(PKG, "csrc", "field.cuh")) as f:
        src = f.read()

    def words(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", src).group(1)
        ws = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
        return sum(w << (32 * i) for i, w in enumerate(ws))

    assert words("kP") == FP.modulus
    assert words("kR1") == FP.r_mod_p
    n0 = int(re.search(r"kN0 = (0x[0-9a-f]+)u", src).group(1), 16)
    assert n0 == FP.n0_32 == (-pow(FP.modulus, -1, 1 << 32)) % (1 << 32)


def test_kernel_wrappers_reject_bad_inputs():
    from tpu_zkpool_torch.msm import kernels
    meta = torch.empty((4, 3, 1, 16), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.addn(meta, meta)
