"""The port's audit-variant harness (``scripts/torch_benchmark_variants.py``)
and what its large circuits lean on, on the CPU:

- the port's ``groth16_ref.setup`` (batch inversion of the Lagrange
  denominators, running products for the H query's scalars) gives keys
  equal field for field to the JAX package's on small circuits, plain and
  committed;
- the native fixed-base batches, split over threads, equal the JAX
  package's single-call ones, G1 and G2;
- the script's ``prove_circuit`` end to end on small circuits with
  ``device="cpu"`` (c = 8, 32 lanes): a plain circuit through
  ``cached_setup`` and a committed one through ``witness_committed``; the
  record carries its keys, both proofs verify and the changed public input
  is rejected;
- partial runs merge into the results file.
"""

import dataclasses
import importlib.util
import json
import os
import random

import pytest
import torch

from tpu_zkpool import native_bridge as jnb
from tpu_zkpool.refimpl import groth16_ref as jref

from tpu_zkpool_torch import native_bridge as nb
from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.groth16.builder import CircuitBuilder
from tpu_zkpool_torch.groth16.cache import cached_setup
from tpu_zkpool_torch.hash import poseidon2
from tpu_zkpool_torch.refimpl.groth16_ref import R1CS, setup

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_benchmark_variants",
        os.path.join(ROOT, "scripts", "torch_benchmark_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny():
    return R1CS(num_vars=5, num_public=2,
                a_rows=[{2: 1}, {3: 1}, {}],
                b_rows=[{2: 1}, {2: 1}, {0: 1}],
                c_rows=[{3: 1}, {4: 1},
                        {1: 1, 4: -1 % R, 2: -1 % R, 0: -5 % R}])


def _tiny_committed():
    return R1CS(
        num_vars=7, num_public=3,
        a_rows=[{3: 1}, {4: 1}, {}, {2: 1}],
        b_rows=[{3: 1}, {3: 1}, {0: 1}, {3: 1}],
        c_rows=[{4: 1}, {5: 1}, {1: 1, 5: -1 % R, 3: -1 % R, 0: -5 % R},
                {6: 1}])


def _small_committed():
    """out = Poseidon2(x)[0] of four private words, two of them range
    checked to 4 bits by the committed log-derivative table (~300 rows)."""
    b = CircuitBuilder()
    v_out = b.public_input()
    v_ch = b.public_input()
    xs = [b.private_input() for _ in range(4)]
    for v in xs[:2]:
        b.commit_wire(v)
        b.range_value({v: 1}, 4)
    s = b.poseidon2_permutation([{v: 1} for v in xs])
    b.assert_eq(s[0], {v_out: 1})
    committed = b.finalize_range_checks(v_ch)
    vals = [5, 11, 123456789, 2**200 + 7]
    out = poseidon2.permutation_ref(vals)[0]
    return b, {v_out: out, **dict(zip(xs, vals))}, [out], committed, v_ch


def _small_plain():
    """out = x^5 + y and y public: four rows."""
    b = CircuitBuilder()
    v_out = b.public_input()
    v_y = b.public_input()
    x = b.private_input()
    b.assert_eq({b.pow5({x: 1}): 1, v_y: 1}, {v_out: 1})
    x0, y0 = 7, 1234
    return b, {v_out: (x0**5 + y0) % R, v_y: y0, x: x0}, [
        (x0**5 + y0) % R, y0]


def _fields_equal(a, b):
    return all(getattr(a, f.name) == getattr(b, f.name)
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("case", ["tiny", "tiny_committed",
                                  "small_committed"])
def test_setup_equals_jax(case):
    if case == "tiny":
        r1cs, committed = _tiny(), ()
    elif case == "tiny_committed":
        r1cs, committed = _tiny_committed(), (3,)
    else:
        b, _, _, committed, _ = _small_committed()
        r1cs = b.r1cs()
    pk, vk = setup(r1cs, seed=29, committed=committed)
    jpk, jvk = jref.setup(r1cs, seed=29, committed=committed)
    assert _fields_equal(pk, jpk) and _fields_equal(vk, jvk)
    assert len(pk.h_query) == pk.n_domain - 1


@pytest.mark.parametrize("g", [1, 2])
def test_fixed_base_batches_equal_jax(g):
    rng = random.Random(40 + g)
    ks = [0, 1, R - 1, (1 << 256) - 1] + [rng.randrange(R)
                                          for _ in range(33)]
    mine, theirs = ((nb.g1_gen_mul_batch, jnb.g1_gen_mul_batch) if g == 1
                    else (nb.g2_gen_mul_batch, jnb.g2_gen_mul_batch))
    got = mine(ks)
    assert got == theirs(ks)
    assert got[0] is None and mine([]) == []


RECORD_KEYS = {"constraints", "wires", "witness_s", "satisfied", "check_s",
               "setup_s", "n_domain", "device_pk_upload_s", "tables_s",
               "prove_device_cold_s", "prove_device_warm_s",
               "prove_phases_cold", "prove_phases_warm",
               "launches_per_proof", "verify_s", "verify_launches", "verify",
               "host_rss_gb", "leg_points"}


@pytest.mark.parametrize("committed", [False, True])
def test_prove_circuit_end_to_end_on_cpu(committed, tmp_path):
    vb = _script()
    if committed:
        b, assignment, publics, cw, v_ch = _small_committed()
        rec = vb.prove_circuit(b, assignment, publics, committed=cw,
                               v_challenge=v_ch, device="cpu", c=8,
                               lanes=32, pad_to=0)
        assert rec["committed_wires"] == len(cw)
    else:
        b, assignment, publics = _small_plain()
        rec = vb.prove_circuit(
            b, assignment, publics, device="cpu", c=8, lanes=32, pad_to=0,
            setup_fn=lambda r: cached_setup(r, cache_dir=str(tmp_path)))
        assert len(os.listdir(tmp_path)) == 1     # the cached keys
    assert RECORD_KEYS <= set(rec)
    assert rec["verify"] == [True, True, False, False]
    assert rec["satisfied"] and rec["constraints"] == len(b.a_rows)
    assert {"upload", "msm_a", "msm_b1", "msm_b2", "h_ntt", "msm_h",
            "msm_k", "combine"} <= set(rec["prove_phases_warm"])
    json.dumps(rec)


def test_results_merge_and_pad_rule(tmp_path):
    vb = _script()
    assert [vb.pad_for(r) for r in (4, (1 << 17) - 1, 1 << 17)] == [
        1 << 17, 1 << 17, 0]
    path = str(tmp_path / "v.json")
    vb.merge(path, dict(card="A", results={"x": {"s": 1}}))
    vb.merge(path, dict(card="B", msm={"20": {"ms": 2}}))
    out = vb.merge(path, dict(card="C", results={"y": {"s": 3}}))
    with open(path) as f:
        assert json.load(f) == out
    assert out == dict(card="C", results={"x": {"s": 1}, "y": {"s": 3}},
                       msm={"20": {"ms": 2}})
