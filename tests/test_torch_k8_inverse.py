"""K8's inverse: the constant-time safegcd of ``csrc/field.cuh`` (fp_inv).

A plain Python-int rendition of the kernel's schedule (Bernstein-Yang
divsteps in libsecp256k1's half-delta form, 20 batches of 30 divsteps on
the low 30 bits, each batch a 2x2 matrix applied to f, g and to d, e mod p)
must give pow(a, p - 2, p) and the port's ``FP.inv`` (the twin's Fermat) on
seeded values and on 1, 2, p - 1 and R mod p. Where g++ is present, the
header itself, built with ``-DZK_HOST_TEST``, must give the same limbs,
and its dedicated square the product's.
"""

import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_zkpool_torch.fields.bn254 import FP_MOD
from tpu_zkpool_torch.fields.fctx import FP

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tpu_zkpool_torch", "csrc")
P, R = FP_MOD, 1 << 256
BATCHES, DIVSTEPS = 20, 30        # field.cuh: kDivstepBatches, kDivsteps
M30, W32 = (1 << 30) - 1, (1 << 32) - 1


def _divsteps30(zeta, f, g):
    """30 divsteps on the low words of f (odd) and g, as divsteps30: the
    32-bit wrap of the C kept where the C relies on it."""
    u, v, q, r = 1, 0, 0, 1
    for _ in range(DIVSTEPS):
        c1 = W32 if zeta < 0 else 0
        c2 = W32 if g & 1 else 0
        x, y, z = ((f ^ c1) - c1) & W32, ((u ^ c1) - c1) & W32, \
            ((v ^ c1) - c1) & W32
        g, q, r = (g + (x & c2)) & W32, (q + (y & c2)) & W32, \
            (r + (z & c2)) & W32
        c3 = c1 & c2
        zeta = (zeta ^ (-1 if c3 else 0)) - 1
        f, u, v = (f + (g & c3)) & W32, (u + (q & c3)) & W32, \
            (v + (r & c3)) & W32
        g, u, v = g >> 1, (u << 1) & W32, (v << 1) & W32
    signed = lambda w: w - (1 << 32) if w >> 31 else w
    return zeta, tuple(signed(w) for w in (u, v, q, r))


def safegcd_inverse(x):
    """x^-1 mod p for x in [0, p) by the kernel's schedule, with Python ints
    for f, g, d, e (the C keeps them in nine signed 30-bit limbs)."""
    pinv30 = pow(P, -1, 1 << 30)
    f, g, d, e, zeta = P, x, 0, 1, -1
    for _ in range(BATCHES):
        zeta, (u, v, q, r) = _divsteps30(zeta, f & W32, g & W32)
        # d, e: the same multiple of p as update_de30 (masks on the signs,
        # then the low 30 bits cleared), exact division by 2^30
        md = (u if d < 0 else 0) + (v if e < 0 else 0)
        me = (q if d < 0 else 0) + (r if e < 0 else 0)
        cd, ce = u * d + v * e, q * d + r * e
        md -= (pinv30 * cd + md) & M30
        me -= (pinv30 * ce + me) & M30
        d, e = (cd + P * md) >> 30, (ce + P * me) >> 30
        assert (cd + P * md) % (1 << 30) == 0 and -2 * P < d < P
        f, g = (u * f + v * g) >> 30, (q * f + r * g) >> 30
    assert g == 0 and f in (1, -1)          # the fixed count sufficed
    return (d * f) % P


def _values():
    rng = random.Random(7)
    return [1, 2, P - 1, R % P] + [rng.randrange(1, P) for _ in range(40)]


def test_rendition_matches_fermat_and_fctx():
    vals = _values()
    got = [safegcd_inverse(a) for a in vals]
    assert got == [pow(a, P - 2, P) for a in vals]
    # the kernel inverts the Montgomery aR and multiplies by R^3 mod p
    mont = [safegcd_inverse(a * R % P) * pow(R, 3, P) * pow(R, -1, P) % P
            for a in vals]
    fctx = FP.inv(torch.as_tensor(FP.to_mont(np.asarray(vals, dtype=object))))
    assert [int(v) * R % P for v in FP.from_mont(fctx)] == mont
    assert [m * pow(R, -1, P) % P for m in mont] == got


def test_fixed_count_covers_the_inputs():
    # the divsteps each value needs until g = 0, far below the fixed 600
    # (the half-delta bound for 256-bit inputs is 590)
    def needed(x):
        f, g, zeta, n = P, x, -1, 0       # zeta = -(delta + 1/2)
        while g:
            if zeta < 0 and g & 1:
                f, g, zeta = g, (g - f) // 2, -zeta - 2
            else:
                g, zeta = (g + f * (g & 1)) // 2, zeta - 1
            n += 1
        return n
    assert max(needed(a) for a in _values()) < BATCHES * DIVSTEPS


_DRIVER = r"""
#include <cstdio>
#include "field.cuh"
using namespace zk;
int main() {
  Fp a;
  for (;;) {
    for (int k = 0; k < 8; ++k)
      if (scanf("%x", &a.v[k]) != 1) return 0;
    const Fp r[3] = {fp_inv(a), fp_sqr(a), fp_mul(a, a)};
    for (const Fp& x : r)
      for (int k = 0; k < 8; ++k) printf("%08x ", x.v[k]);
    printf("\n");
  }
}
"""


@pytest.fixture(scope="module")
def host_field(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: field.cuh's host build cannot be made")
    d = tmp_path_factory.mktemp("field_host")
    src, exe = d / "driver.cpp", d / "driver"
    src.write_text(_DRIVER)
    subprocess.run([gxx, "-std=c++17", "-O1", "-DZK_HOST_TEST", f"-I{CSRC}",
                    "-x", "c++", str(src), "-o", str(exe)], check=True,
                   capture_output=True, text=True)
    return str(exe)


def test_field_cuh_inverse_matches_rendition(host_field):
    vals = _values()
    words = lambda x: " ".join(f"{(x >> (32 * k)) & W32:x}" for k in range(8))
    out = subprocess.run([host_field], check=True, capture_output=True,
                         text=True,
                         input="\n".join(words(a * R % P) for a in vals))
    lines = out.stdout.split("\n")
    for a, line in zip(vals, lines):
        w = [int(x, 16) for x in line.split()]
        inv, sqr, mul = [sum(w[8 * f + k] << (32 * k) for k in range(8))
                         for f in range(3)]
        assert inv == safegcd_inverse(a * R % P) * pow(R, 2, P) % P  # a^-1 R
        assert sqr == mul == a * a * R % P
    assert len([ln for ln in lines if ln.strip()]) == len(vals)
