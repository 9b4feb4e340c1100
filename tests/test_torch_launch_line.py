"""The launch line of ``chip_smoke.py`` phase 12 and its row filter.

Phase 12 extrapolates the CUDA launches of the A8 loops
(``FixedBaseTable.mul``, a window a step; ``CurveOps.scalar_mul``, a bit a
step) from profiles of 1 and 2 steps as base + n x step, name by name
(``profiling.launch_line``), and holds a keygen's line to one whole
profile. That rests on the loops dispatching the same ops, by name, at
every step whatever the data: checked here on the CPU under
``TorchDispatchMode`` at 1, 2 and 4 steps over two input sets, one of them
with zero digits, zero bits and identity lanes, at a batch on the side of
``FieldCtx``'s product-column switch (``_OUTER_MAX`` lanes) where the
checked keygen of B = 256 lies. The filter
that splits a profile's rows into the host's launch calls (the count), the
card's kernel records and the copy and fill calls
(``profiling.split_launches``) is checked on stand-in rows.
"""

import collections
import random
from types import SimpleNamespace

import torch
from torch.autograd import DeviceType
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_zkpool_torch.curve import fixed_base as fb
from tpu_zkpool_torch.curve.weierstrass import EMBEDDED
from tpu_zkpool_torch.fields import fctx
from tpu_zkpool_torch.utils.profiling import launch_line, split_launches

STEPS = (1, 2, 4)
B = 6


class _AtenCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _dispatched(fn):
    m = _AtenCount()
    with m:
        fn()
    return {str(f): v for f, v in m.ops.items()}


def _keygen_inputs(B, seed):
    """(random digits, digits with zero windows and all-zero lanes) of the
    c = 8 embedded table for B scalars."""
    tbl = fb.embedded_generator_table(8, device="cpu")
    rng = random.Random(seed)
    ks = [rng.getrandbits(128) for _ in range(B)]
    zero = [0, 1 << 8, 0, (1 << 24) | 5] + ks[4:]    # 0, zero low windows
    zero[-1] = 0
    return tbl, [torch.as_tensor(tbl.digits(k)) for k in (ks, zero)]


def _scalar_mul_inputs(B, seed):
    """(bits, points): random bits of the generator, then zero bits on some
    lanes and the identity on others."""
    C = EMBEDDED
    rng = random.Random(seed)
    bits = torch.as_tensor(C.bits_from_ints(
        [rng.getrandbits(8) for _ in range(B)], 8))
    G = C.from_affine_ints([C.gen[0]] * B, [C.gen[1]] * B, device="cpu")
    zbits = bits.clone()
    zbits[::2] = 0
    inf = torch.arange(B) % 3 == 0
    Gi = tuple(torch.where(inf[:, None], 0, t) for t in G)
    return [(bits, G), (zbits, Gi)]


def _counts(step_fn):
    """{n: ops by name} at each of STEPS, after one first-use call."""
    step_fn(1)
    return {n: _dispatched(lambda: step_fn(n)) for n in STEPS}


def test_keygen_ops_follow_the_line_whatever_the_digits():
    assert B <= 256 <= fctx._OUTER_MAX
    tbl, digit_sets = _keygen_inputs(B, seed=5)
    counts = [_counts(lambda n, d=d: tbl.mul(d[:, :n])) for d in digit_sets]
    assert counts[0] == counts[1]
    got = counts[0]
    assert launch_line(got[1], got[2], 4) == got[4]
    assert sum(got[2].values()) > sum(got[1].values()) > 0


def test_scalar_mul_ops_follow_the_line_whatever_the_bits():
    counts = [_counts(lambda n, b=b, P=P: EMBEDDED.scalar_mul(b[:, :n], P))
              for b, P in _scalar_mul_inputs(B, seed=6)]
    assert counts[0] == counts[1]
    got = counts[0]
    assert launch_line(got[1], got[2], 4) == got[4]


def test_launch_line_by_name():
    one = {"mul": 10, "add": 5, "fill": 1}
    two = {"mul": 19, "add": 9, "fill": 1, "late": 2}
    # base 1, step 9; base 1, step 4; base 1, step 0; base -2, step 2
    assert launch_line(one, two, 4) == {"mul": 37, "add": 17, "fill": 1,
                                        "late": 6}
    assert launch_line(one, two, 1) == one
    assert launch_line(one, two, 2) == two
    assert launch_line({"gone": 2}, {"gone": 1}, 3) == {}


def test_split_launches_rows():
    def row(key, count, dev=DeviceType.CUDA):
        return SimpleNamespace(key=key, count=count, device_type=dev)

    rows = [row("k_fr_pass", 5), row("Memcpy DtoD (Device -> Device)", 2),
            row("Memset (Device)", 1),
            row("void at::native::elementwise_kernel<128, 2>", 40),
            row("cudaLaunchKernel", 46, DeviceType.CPU),
            row("cudaLaunchKernelExC", 1, DeviceType.CPU),
            row("cuLaunchKernel", 1, DeviceType.CPU),
            row("cudaLaunchCooperativeKernel", 1, DeviceType.CPU),
            row("cudaMemcpyAsync", 2, DeviceType.CPU),
            row("cudaMemsetAsync", 1, DeviceType.CPU),
            row("cudaDeviceSynchronize", 2, DeviceType.CPU),
            row("cudaFuncGetAttributes", 1, DeviceType.CPU),
            row("cudaGraphLaunch", 1, DeviceType.CPU),
            row("aten::add", 40, DeviceType.CPU),
            row("k_fr_pass", 1)]
    launches, kernels, copies = split_launches(rows)
    # the host's launch calls count; the card's records only name kernels
    assert launches == {"cudaLaunchKernel": 46, "cudaLaunchKernelExC": 1,
                        "cuLaunchKernel": 1, "cudaLaunchCooperativeKernel": 1}
    assert kernels == {"k_fr_pass": 6,
                       "void at::native::elementwise_kernel<128, 2>": 40}
    assert copies == {"cudaMemcpyAsync": 2, "cudaMemsetAsync": 1}
    assert split_launches([]) == ({}, {}, {})
