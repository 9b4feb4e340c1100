"""Port parity: the MSM benchmark's inputs (``tpu_zkpool_torch.benchvec``)
against ``tpu_zkpool.benchvec``: the generator consumed in the same order,
the device arrays equal to the JAX package's limbs, the committed table
read alike. Each package's disk cache goes to a directory of the test's."""

import json

import numpy as np
import pytest
import torch

from tpu_zkpool import benchvec as jbv

from tpu_zkpool_torch import benchvec as bv
from tpu_zkpool_torch.fields.limbs import from_jax


@pytest.mark.parametrize("log2n,seed", [(10, 7), (4, 3)])
def test_msm_inputs_equal_jax(log2n, seed):
    assert bv.msm_inputs(log2n, seed) == jbv.msm_inputs(log2n, seed)


def test_device_arrays_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(bv, "_VEC_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jbv, "_VEC_DIR", str(tmp_path / "jax"))
    got = bv.msm_device_arrays(10, device="cpu")
    want = jbv.msm_device_arrays(10)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == (1024, 16)
        assert torch.equal(g, from_jax(np.asarray(w), device="cpu"))
    assert len(list((tmp_path / "port").iterdir())) == 1
    again = bv.msm_device_arrays(10, device="cpu")      # from the cache
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_device_arrays_ask_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bv.msm_device_arrays(4)


def test_expected_table(tmp_path):
    for log2n in (17, 20, 22):
        assert bv.expected_key(log2n) == jbv.expected_key(log2n)
        assert bv.load_expected(log2n) == jbv.load_expected(log2n)
        assert bv.load_expected(log2n) is not None
    assert bv.load_expected(5) is None
    path = tmp_path / "expected.json"
    bv.store_expected(5, (1, 2), path=str(path))
    bv.store_expected(6, (3, 4), seed=9, path=str(path))
    assert json.loads(path.read_text()) == {
        "msm_g1_seed7_log5": ["0x1", "0x2"],
        "msm_g1_seed9_log6": ["0x3", "0x4"]}
