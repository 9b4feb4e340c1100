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
- P3's g++ build equals the plain versions in both forms, launched as the
  wrapper shapes the grid (16 threads a state), on ragged batches (B = 1,
  3, 9: two states a warp) and in blocks of 32 and 128 threads;
- ``lanes.cuh``'s split addition and product (4 lanes a value), which P3
  runs, equal (a + b) mod r and a b 2^-256 mod r on edge values.

The g++ builds run a block's threads as fibers on one host thread
(``_SHIMS``), each barrier handing control to the next thread, with the
warp's shuffles and ballots on per-lane slots.
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
from tpu_zkpool_torch.hash.kernels import block_size

from host_fibers import SHIMS as _SHIMS

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
                    ("kP2Width", p2.T), ("kP2Split", p2k.SPLIT)):
        assert f"constexpr int {name} = {v};" in src
    assert "kP2Lanes = kP2Width * kP2Split;" in src


_HARNESS = _SHIMS + r"""#include "poseidon2_host.cu"
using namespace zk;

static int g_mode, g_B, g_n;
static const int64_t* g_in;
static int64_t* g_out;
static const uint4* g_tab;

static void p3_thread() {
  if (g_mode == 0)
    k_poseidon2<0>(g_in, g_out, g_tab, g_B, g_n);
  else
    k_poseidon2<1>(g_in, g_out, g_tab, g_B, g_n);
}

// stdin: mode, B, n, block, the table (96 x 8 words), the inputs; stdout:
// the outputs. The grid the launcher gives (kP2Lanes threads a state, B
// states, `block` threads a block), its blocks one after another.
int main() {
  std::vector<int64_t> h = rd(4);
  g_mode = (int)h[0];
  g_B = (int)h[1];
  g_n = (int)h[2];
  const int block = (int)h[3];
  std::vector<int64_t> tw = rd(kP2Table * 8);
  std::vector<uint4> tab(2 * kP2Table);
  uint32_t* w = reinterpret_cast<uint32_t*>(tab.data());
  for (int i = 0; i < kP2Table * 8; ++i) w[i] = (uint32_t)tw[i];
  std::vector<int64_t> in = rd((size_t)g_B * g_n * 16);
  // two more states' rows than the outputs: a dead state must store nothing
  const size_t row = (g_mode ? 1 : 4) * 16;
  std::vector<int64_t> out((size_t)(g_B + 2) * row, -7);
  g_in = in.data();
  g_out = out.data();
  g_tab = tab.data();
  if (block % 32 || block > 128) std::abort();
  const long long threads = (long long)g_B * kP2Lanes;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  for (unsigned b = 0; b < grid; ++b) {
    blockIdx.x = b;
    zk_run_block(block, p3_thread);
  }
  for (size_t i = (size_t)g_B * row; i < out.size(); ++i)
    if (out[i] != -7) std::abort();
  fwrite(out.data(), 8, (size_t)g_B * row, stdout);
}
"""

# lanes.cuh alone: split_add and split_mul on 4 lanes a value, eight pairs a
# warp, against Python's (a + b) mod r and a b 2^-256 mod r.
_SPLIT_MAIN = r"""#include "field.cuh"
#include "lanes.cuh"
using namespace zk;

static std::vector<int64_t> g_in, g_out;
static size_t g_pair;

static void split_thread() {
  using S = Split<FrMod, 4>;
  const unsigned t = threadIdx.x, q = t % 4, i = g_pair + t / 4;
  const int64_t* a = &g_in[16 * i];
  const S x{{(uint32_t)a[2 * q], (uint32_t)a[2 * q + 1]}};
  const S y{{(uint32_t)a[8 + 2 * q], (uint32_t)a[8 + 2 * q + 1]}};
  const S p = split_modulus<FrMod, 4>();
  const S s = split_add(x, y, p), m = split_mul(x, y, p);
  int64_t* o = &g_out[16 * i];
  o[2 * q] = s.v[0];
  o[2 * q + 1] = s.v[1];
  o[8 + 2 * q] = m.v[0];
  o[8 + 2 * q + 1] = m.v[1];
}

// stdin: n, then n pairs of 8 + 8 words (n a multiple of 8); stdout: n
// times the sum's 8 words and the product's 8.
int main() {
  const size_t n = (size_t)rd(1)[0];
  g_in = rd(16 * n);
  g_out.assign(16 * n, -7);
  for (g_pair = 0; g_pair < n; g_pair += 8) zk_run_block(32, split_thread);
  fwrite(g_out.data(), 8, g_out.size(), stdout);
}
"""


def _gxx(d, name, src):
    """Build ``src`` with g++ in ``d`` (``-DZK_HOST_TEST`` from the shims,
    csrc/ on the include path); returns the executable's path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: the host build cannot be made")
    (d / f"{name}.cpp").write_text(src)
    exe = d / name
    subprocess.run([gxx, "-std=c++17", "-O1", f"-I{CSRC}", f"-I{d}", "-x",
                    "c++", str(d / f"{name}.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
    return str(exe)


@pytest.fixture(scope="module")
def host_p3(tmp_path_factory):
    """poseidon2.cu built with g++ -DZK_HOST_TEST: the source cut at the
    end of its namespace (the launcher follows), without
    <cuda_runtime.h>."""
    d = tmp_path_factory.mktemp("poseidon2_host")
    with open(os.path.join(CSRC, "poseidon2.cu")) as f:
        src = f.read()
    end = "}  // namespace zk"
    src = src[:src.rindex(end) + len(end)].replace(
        "#include <cuda_runtime.h>\n", "")
    (d / "poseidon2_host.cu").write_text(src + "\n")
    return _gxx(d, "harness", _HARNESS)


def _host(exe, mode, x, block=None):
    """P3's g++ build on x, launched as the wrapper launches it: ``block``
    threads a block (default the wrapper's ``block_size`` on a card of 132
    SMs), 16 a state."""
    B, n = x.shape[0], x.shape[1]
    if block is None:
        block = block_size(B * p2k.LANES, 132)
    words = np.concatenate([[mode, B, n, block], p2.kernel_words().view(
        np.uint32).astype(np.int64).ravel(), x.numpy().ravel()])
    out = subprocess.run([exe], input=words.astype(np.int64).tobytes(),
                         capture_output=True, check=True).stdout
    shape = (B, 4, 16) if mode == 0 else (B, 16)
    return torch.as_tensor(np.frombuffer(out, np.int64).reshape(shape).copy())


def test_kernel_on_the_host_permutation(host_p3):
    x = _mont(_states(21), (9, 4))
    assert torch.equal(_host(host_p3, 0, x), p2.permutation_plain(x))


@pytest.mark.parametrize("B, block", [(1, None), (3, None), (9, None),
                                      (9, 128)])
@pytest.mark.parametrize("mode", [0, 1])
def test_kernel_on_the_host_ragged(host_p3, mode, B, block):
    """Batches that fill no warp (two states a warp) or block: the dead
    states run on zeros beside the live ones and store nothing."""
    rng = random.Random(300 + 10 * B + mode)
    n = p2.T   # the sponge: a block of three fields and a remainder of one
    vals = [[rng.choice([0, 1, R - 1, rng.randrange(R)]) for _ in range(n)]
            for _ in range(B)]
    x = _mont(vals, (B, n))
    want = (p2.ct_commitment_plain(x) if mode
            else p2.permutation_plain(x))
    assert torch.equal(_host(host_p3, mode, x, block), want)


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


def test_split_field_on_the_host(tmp_path):
    """lanes.cuh's split_add and split_mul (4 lanes a value, as P3 runs
    them) on values whose sums and products carry through whole lanes of
    all-ones words, meet r exactly or wrap: 0, 1, r - 1, 2^64k - 1, 2^64k,
    (r -+ 1) / 2, random values and their negations, every pair."""
    exe = _gxx(tmp_path, "split", _SHIMS + _SPLIT_MAIN)
    rng = random.Random(17)
    edge = [0, 1, R - 1, (R - 1) // 2, (R + 1) // 2]
    for k in (1, 2, 3):
        edge += [(1 << 64 * k) - 1, 1 << 64 * k, (1 << 64 * k) + 1]
    vals = edge + [rng.randrange(R) for _ in range(4)]
    vals += [(R - v) % R for v in vals if v]
    pairs = [(a, b) for a in vals for b in vals]
    pairs += [(0, 0)] * (-len(pairs) % 8)
    words = [[(v >> 32 * i) & 0xFFFFFFFF for v in ab for i in range(8)]
             for ab in pairs]
    inp = np.asarray([len(pairs)] + sum(words, []), dtype=np.int64)
    out = subprocess.run([exe], input=inp.tobytes(), capture_output=True,
                         check=True).stdout
    got = np.frombuffer(out, np.int64).reshape(len(pairs), 2, 8)
    rinv = pow(1 << 256, -1, R)
    for (a, b), (s, m) in zip(pairs, got):
        assert sum(int(w) << 32 * i for i, w in enumerate(s)) == (a + b) % R
        assert sum(int(w) << 32 * i for i, w in enumerate(m)) == (
            a * b * rinv % R)


def test_wrappers_check_shapes_on_the_cpu():
    with pytest.raises(ValueError, match=r"\(B, 4, 16\)"):
        p2k.permute(torch.zeros((2, 3, 16), dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        p2k.sponge(torch.zeros((2, 3, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(B, n, 16\)"):
        p2k.sponge(torch.zeros((2, 16), dtype=torch.int64))
