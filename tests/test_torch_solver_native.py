"""Port parity: the native CSR row evaluation and witness packing of
``tpu_zkpool_torch.groth16.solver_native`` (over ``native/witness.cpp``)
against ``r1cs.eval_row`` and the JAX package's ``solver_native``, exact.

The port builds the shared source into its own build directory. The JAX
package builds it beside the source; the tests point its build at a
temporary directory instead, so nothing is written in ``native/``.
"""

import os
import random

import numpy as np
import pytest

from tpu_zkpool.groth16 import solver_native as jsn

from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.fields.limbs import ints_to_limbs, pack_limbs16
from tpu_zkpool_torch.groth16 import solver_native as sn
from tpu_zkpool_torch.native_bridge import BUILD_DIR
from tpu_zkpool_torch.refimpl.groth16_ref import R1CS


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's library of the same source, built in a temporary
    directory."""
    saved = jsn._LIB, jsn._lib
    jsn._LIB = str(tmp_path_factory.mktemp("jax_witness") / "libwitness.so")
    jsn._lib = None
    yield jsn
    jsn._LIB, jsn._lib = saved


def _circuit(m=300, nv=120, seed=5):
    """Seeded rows of 0-4 terms over nv variables, coefficients anywhere in
    [0, r) (0, 1 and r - 1 among them), and a witness with 0, 1, r - 1."""
    rng = random.Random(seed)
    special = [0, 1, R - 1]

    def row():
        return {rng.randrange(nv): (special[rng.randrange(3)]
                                    if rng.random() < 0.2
                                    else rng.randrange(R))
                for _ in range(rng.randrange(5))}

    rows = [[row() for _ in range(m)] for _ in range(3)]
    r1cs = R1CS(num_vars=nv, num_public=2, a_rows=rows[0], b_rows=rows[1],
                c_rows=rows[2])
    w = [1] + [special[i % 3] if i < 9 else rng.randrange(R)
               for i in range(1, nv)]
    return r1cs, w


def _ints(u64):
    return [int(r[0]) | int(r[1]) << 64 | int(r[2]) << 128 | int(r[3]) << 192
            for r in u64]


def test_eval_rows_equal_eval_row_and_jax(jax_lib):
    r1cs, w = _circuit()
    w64 = sn.ints_to_u64x4(w)
    for i, rows in enumerate((r1cs.a_rows, r1cs.b_rows, r1cs.c_rows)):
        got = sn.eval_rows_native(("t", id(r1cs), i), rows, w64)
        assert got.dtype == np.uint64 and got.shape == (len(rows), 4)
        assert _ints(got) == [r1cs.eval_row(r, w) for r in rows]
        # warm: the cached CSR gives the same rows
        again = sn.eval_rows_native(("t", id(r1cs), i), rows, w64)
        assert (again == got).all()
        want = jax_lib.eval_rows_native(("t", id(r1cs), i), rows,
                                        jax_lib.ints_to_u64x4(w))
        assert (got == want).all()


def test_eval_rows_rebuilds_for_other_rows_under_one_key():
    r1cs, w = _circuit(m=40, seed=6)
    other, _ = _circuit(m=40, seed=7)
    w64 = sn.ints_to_u64x4(w)
    sn.eval_rows_native("key", r1cs.a_rows, w64)
    got = sn.eval_rows_native("key", other.a_rows, w64)
    assert _ints(got) == [other.eval_row(r, w) for r in other.a_rows]


def test_eval_rows_rejects_a_short_witness():
    r1cs, w = _circuit(m=40, seed=8)
    with pytest.raises(ValueError, match="witness"):
        sn.eval_rows_native(("short", id(r1cs)), r1cs.a_rows,
                            sn.ints_to_u64x4(w[:10]))


def test_ints_to_u64x4_equals_jax_and_packs_limbs():
    rng = random.Random(9)
    vals = [0, 1, R - 1, (1 << 256) - 1] + [rng.randrange(R)
                                           for _ in range(50)]
    got = sn.ints_to_u64x4(vals)
    assert (got == jsn.ints_to_u64x4(vals)).all()
    # viewed as uint32 words it is the prover's packed wire format
    assert (got.view("<u4") == pack_limbs16(ints_to_limbs(vals))).all()
    mont = sn.to_mont_batch(sn.ints_to_u64x4(vals[:3] + [5]))
    assert _ints(mont) == [v * (1 << 256) % R for v in vals[:3] + [5]]


def test_library_builds_in_the_port_build_dir():
    path = sn.lib_path()
    assert os.path.dirname(path) == BUILD_DIR
    assert os.path.basename(path).startswith("libwitness_")
    lib = sn.get_lib()
    assert os.path.realpath(lib._name) == os.path.realpath(path)
    assert os.path.exists(path)
    native = os.path.join(os.path.dirname(os.path.dirname(BUILD_DIR)),
                          "native")
    assert not os.path.realpath(path).startswith(os.path.realpath(native))
