"""Port parity: Poseidon2 (``tpu_zkpool_torch.hash.poseidon2``) against
``tpu_zkpool.hash.poseidon2``, exact, and the kernel P3
(``csrc/poseidon2.cu``) built with g++ against its plain versions.

- the port's oracles give Barretenberg's permutation(0, 1, 2, 3) and first
  round constants, and the JAX package's constants;
- ``permutation_plain`` equals the JAX ``permutation`` (jitted once) limb
  for limb, on states with 0, 1 and r - 1 planted, fed to both through the
  carry-across (``limbs.from_jax``);
- ``ct_commitment_plain`` equals ``ct_commitment_ref`` at n = 0 .. 8 and at
  the audit's 157 packed fields;
- P3's g++ build equals the plain versions in both forms.
"""

import os
import random
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_zkpool.fields.fctx import FR as JFR
from tpu_zkpool.hash import poseidon2 as jp2

from tpu_zkpool_torch.fields.fctx import FR
from tpu_zkpool_torch.fields.limbs import from_jax
from tpu_zkpool_torch.hash import poseidon2 as p2
from tpu_zkpool_torch.hash import poseidon2_kernels as p2k

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_zkpool_torch", "csrc")
R = FR.modulus


def _states(seed, n=6):
    """Rows of 4 Fr ints: the bb vector's input, then 0, 1 and r - 1
    planted among random values."""
    rng = random.Random(seed)
    rows = [[0, 1, 2, 3], [0, 0, 0, 0], [R - 1] * 4]
    for _ in range(n):
        rows.append([rng.choice([0, 1, R - 1, rng.randrange(R)])
                     for _ in range(4)])
    return rows


def _mont(vals, shape):
    return torch.as_tensor(FR.to_mont(np.asarray(vals, dtype=object)
                                      .reshape(shape))).reshape(
        tuple(shape) + (16,))


def test_bb_vector_and_constants():
    assert p2.permutation_ref([0, 1, 2, 3]) == [
        0x01bd538c2ee014ed5141b29e9ae240bf8db3fe5b9a38629a9647cf8d76c01737,
        0x239b62e7db98aa3a2a8f6a0d2fa1709e7a35959aa6c7034814d9daa90cbac662,
        0x04cbb44c61d928ed06808456bf758cbf0c18d1e15a7b6dbc8245fa7515d5e3cb,
        0x2e11c5cff2a22c64d01304b778d78f6998eff1ab73163a35603f54794c30847a,
    ]
    ext, internal, diag = p2.poseidon2_constants()
    assert ext[0][:2] == [
        0x19b849f69450b06848da1d39bd5e4a4302bb86744edc26238b0878e269ed23e5,
        0x265ddfe127dd51bd7239347b758f0a1320eb2cc7450acc1dad47f80c8dcf34d6]
    assert (ext, internal, diag) == tuple(jp2.poseidon2_constants())
    assert len(ext) == 8 and len(internal) == 56 and diag == jp2.DIAG_M1
    assert p2.M4 == jp2.M4


def test_permutation_plain_equals_jax():
    rows = _states(11)
    limbs = JFR.to_mont(np.asarray(rows, dtype=object))     # uint32 JAX
    want = np.asarray(jax.jit(jp2.permutation)(jnp.asarray(limbs)))
    got = p2.permutation_plain(from_jax(limbs, device="cpu"))
    assert (got.numpy() == want.astype(np.int64)).all()
    assert [[int(v) for v in r] for r in FR.from_mont(got)] == [
        p2.permutation_ref(r) for r in rows]
    # the entry point on a CPU tensor is the plain version
    assert torch.equal(p2.permutation(got), p2.permutation_plain(got))


@pytest.mark.parametrize("n", list(range(9)) + [157])
def test_ct_commitment_plain_equals_ref(n):
    rng = random.Random(100 + n)
    # packed ciphertext fields are 224-bit; plant 0, 1 and r - 1 too
    vals = [[rng.choice([0, 1, R - 1, rng.randrange(1 << 224)])
             for _ in range(n)] for _ in range(2)]
    packed = _mont(vals, (2, n))
    got = p2.ct_commitment_plain(packed)
    assert [int(v) for v in FR.from_mont(got)] == [
        p2.ct_commitment_ref(v) for v in vals]
    if n < 4:   # the entry point on a CPU tensor is the plain version
        assert torch.equal(p2.ct_commitment(packed), got)


def test_kernel_words_are_the_constants():
    words = p2.kernel_words().view(np.uint32).astype(object)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row))
            for row in words]
    ext, internal, diag = p2.poseidon2_constants()
    flat = [x for row in ext for x in row] + internal + diag
    assert vals == [v * (1 << 256) % R for v in flat]
    with open(os.path.join(CSRC, "poseidon2.cu")) as f:
        src = f.read()
    for name, v in (("kP2FullRounds", p2.R_F), ("kP2PartialRounds", p2.R_P),
                    ("kP2Width", p2.T)):
        assert f"constexpr int {name} = {v};" in src


_HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
#include "field.cuh"
inline void __syncthreads() {}
#include "poseidon2_host.cu"
using namespace zk;

static std::vector<int64_t> rd(size_t n) {
  std::vector<int64_t> v(n);
  if (n && fread(v.data(), 8, n, stdin) != n) std::abort();
  return v;
}

// stdin: mode, B, n, the table (96 x 8 words), the inputs; stdout: the
// outputs. Blocks of one thread, one after another (each block loads the
// whole table before its thread runs).
int main() {
  std::vector<int64_t> h = rd(3);
  const int mode = (int)h[0], B = (int)h[1], n = (int)h[2];
  std::vector<int64_t> tw = rd(kP2Table * 8);
  std::vector<uint4> tab(2 * kP2Table);
  uint32_t* w = reinterpret_cast<uint32_t*>(tab.data());
  for (int i = 0; i < kP2Table * 8; ++i) w[i] = (uint32_t)tw[i];
  std::vector<int64_t> in = rd((size_t)B * n * 16);
  std::vector<int64_t> out((size_t)B * (mode ? 1 : 4) * 16);
  blockDim.x = 1;
  for (unsigned b = 0; b < (unsigned)B; ++b) {
    blockIdx.x = b;
    if (mode == 0)
      k_poseidon2<0>(in.data(), out.data(), tab.data(), B, n);
    else
      k_poseidon2<1>(in.data(), out.data(), tab.data(), B, n);
  }
  fwrite(out.data(), 8, out.size(), stdout);
}
"""


@pytest.fixture(scope="module")
def host_p3(tmp_path_factory):
    """poseidon2.cu built with g++ -DZK_HOST_TEST: the source cut at the
    end of its namespace (the launcher follows), without
    <cuda_runtime.h>."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: poseidon2.cu's host build cannot be made")
    d = tmp_path_factory.mktemp("poseidon2_host")
    with open(os.path.join(CSRC, "poseidon2.cu")) as f:
        src = f.read()
    end = "}  // namespace zk"
    src = src[:src.rindex(end) + len(end)].replace(
        "#include <cuda_runtime.h>\n", "")
    (d / "poseidon2_host.cu").write_text(src + "\n")
    (d / "harness.cpp").write_text(_HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", "-DZK_HOST_TEST", f"-I{CSRC}",
                    f"-I{d}", "-x", "c++", str(d / "harness.cpp"), "-o",
                    str(exe)], check=True, capture_output=True, text=True)
    return str(exe)


def _host(exe, mode, x):
    B, n = x.shape[0], x.shape[1]
    words = np.concatenate([[mode, B, n], p2.kernel_words().view(
        np.uint32).astype(np.int64).ravel(), x.numpy().ravel()])
    out = subprocess.run([exe], input=words.astype(np.int64).tobytes(),
                         capture_output=True, check=True).stdout
    shape = (B, 4, 16) if mode == 0 else (B, 16)
    return torch.as_tensor(np.frombuffer(out, np.int64).reshape(shape).copy())


def test_kernel_on_the_host_permutation(host_p3):
    x = _mont(_states(21), (9, 4))
    assert torch.equal(_host(host_p3, 0, x), p2.permutation_plain(x))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 7])
def test_kernel_on_the_host_sponge(host_p3, n):
    rng = random.Random(200 + n)
    vals = [[rng.choice([0, 1, R - 1, rng.randrange(R)]) for _ in range(n)]
            for _ in range(3)]
    x = _mont(vals, (3, n))
    got = _host(host_p3, 1, x)
    assert torch.equal(got, p2.ct_commitment_plain(x))
    assert [int(v) for v in FR.from_mont(got)] == [
        p2.ct_commitment_ref(v) for v in vals]


def test_wrappers_check_shapes_on_the_cpu():
    with pytest.raises(ValueError, match=r"\(B, 4, 16\)"):
        p2k.permute(torch.zeros((2, 3, 16), dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        p2k.sponge(torch.zeros((2, 3, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(B, n, 16\)"):
        p2k.sponge(torch.zeros((2, 16), dtype=torch.int64))
