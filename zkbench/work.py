"""The work of a Groth16 proof's MSMs counted from their inputs alone, and
the card's peaks: the yardstick of ``msm_roofline``.

An MSM of n points and 254-bit scalars needs at least the Fp products of a
signed-digit Pippenger at the window c that minimises them:

- n x ceil(254 / c) mixed additions into the buckets;
- per window, the 2^(c-1) buckets summed by running sums, 2 (2^(c-1) - 1)
  additions;
- the windows combined by Horner, (W - 1) (c doublings + 1 addition).

Formula costs are the Explicit-Formulas Database's for short Weierstrass
curves with a = 0 in Jacobian coordinates (hyperelliptic.org/EFD,
g1p/auto-shortw-jacobian-0.html), a square counted as a product:
madd-2007-bl 7M + 4S, add-2007-bl 11M + 5S, dbl-2009-l 2M + 5S. Over G2
an Fp2 product counts as 3 Fp products. An Fp product is 264 32-bit
multiply-adds (8 x 8 word products, each a low and a high half, and 8
word products of the reduction). Bytes: each affine point and each 32-byte
scalar read once. None of it reads how the port computes the MSM, so a
redesign of its kernels, its window or its lanes leaves the count as it is.
"""

from __future__ import annotations

import json
import os

SCALAR_BITS = 254
MADD, ADD, DBL = 11, 16, 7          # Fp products (squares counted as one)
FP_MADDS = 264                       # 32-bit multiply-adds an Fp product
POINT_BYTES = {"g1": 64, "g2": 128}
FP_PER = {"g1": 1, "g2": 3}          # Fp products an F_q^k product

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def products(n: int, c: int) -> int:
    """Fp products (over the curve's own field) of the Pippenger above at
    window c, every digit taken as non-zero."""
    windows = -(-SCALAR_BITS // c)
    buckets = 1 << (c - 1)
    return (windows * n * MADD + windows * 2 * (buckets - 1) * ADD
            + (windows - 1) * (c * DBL + ADD))


def least_products(n: int, group: str = "g1") -> tuple:
    """(Fp products, c) at the window that needs the fewest."""
    best = min((products(n, c), c) for c in range(1, 25))
    return best[0] * FP_PER[group], best[1]


def msm_bytes(n: int, group: str = "g1") -> int:
    return n * (POINT_BYTES[group] + 32)


def peaks(card: str):
    """The card's peaks from ``peaks.json`` (None for a card not there)."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    return table.get(card)


def least_seconds(n: int, group: str, peak: dict) -> tuple:
    """(least seconds, "ops" or "bytes": the bound that holds)."""
    prods, _ = least_products(n, group)
    madd_rate = peak["sms"] * peak["int32_madd_per_clk_per_sm"] * \
        peak["boost_mhz"] * 1e6
    t_ops = prods * FP_MADDS / madd_rate
    t_bytes = msm_bytes(n, group) / peak["hbm_bytes_per_s"]
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
