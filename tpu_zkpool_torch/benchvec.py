"""Deterministic benchmark input vectors + precommitted expected results.

The port's copy of ``tpu_zkpool/benchvec.py``: ``msm_inputs`` consumes its
generator in exactly the JAX module's order, so the committed points in
``bench_expected.json`` (the MSM of ``msm_inputs(log2n, seed)``, computed
once by the native Pippenger oracle) hold for the port's MSM too. The port
reads that file and never writes it (``store_expected`` writes a table
at a path its caller names).

``msm_device_arrays`` gives the port's layout (int64 16-bit limbs,
Montgomery coordinates, plain scalar limbs) on a device, with the base
points from the native fixed-base multiply; the host arrays are cached
under ``~/.cache/tpu_zkpool_torch_benchvec``, one file a (version, seed,
size).
"""

from __future__ import annotations

import json
import os
import random

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPECTED_PATH = os.path.join(_REPO, "bench_expected.json")

MSM_SEED = 7


def msm_inputs(log2n: int, seed: int = MSM_SEED):
    """Base-point exponents and MSM scalars for the bench MSM metric.

    Must consume the RNG in exactly this order — the committed expected
    points depend on it.
    """
    from tpu_zkpool_torch.fields.bn254 import FR_MOD

    n = 1 << log2n
    rng = random.Random(seed)
    base = [rng.randrange(1, 1 << 62) for _ in range(n)]
    ks = [rng.randrange(0, FR_MOD) for _ in range(n)]
    return base, ks


_VEC_DIR = os.path.expanduser("~/.cache/tpu_zkpool_torch_benchvec")

# Bump whenever the input recipe (msm_inputs), the limb layout
# (fields/limbs.py) or the Montgomery encoding changes: the version is part
# of the file name, so arrays of an older encoding are never served.
_VEC_VERSION = 1


def msm_device_arrays(log2n: int, seed: int = MSM_SEED, device=None):
    """(X, Y, Z, scalar_limbs) int64[N, 16] on ``device`` (``cuda`` unless
    named) for the bench MSM: the points' Jacobian coordinates in
    Montgomery form (Z = R), the scalars' plain limbs, as
    ``msm.grid.msm_grid_g1`` takes them. The host arrays (16-bit words)
    build once per (seed, size) and are cached on disk: the fixed-base
    multiplies and the bigint Montgomery conversion take minutes at
    2^20."""
    from tpu_zkpool_torch import native_bridge
    from tpu_zkpool_torch.fields.fctx import FP
    from tpu_zkpool_torch.fields.limbs import ints_to_limbs

    device = resolve_device(device)
    path = os.path.join(
        _VEC_DIR, f"msm_g1_v{_VEC_VERSION}_seed{seed}_log{log2n}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            X, Y, L = z["X"], z["Y"], z["L"]
    else:
        base, ks = msm_inputs(log2n, seed)
        aff = native_bridge.g1_gen_mul_batch(base)
        X = FP.to_mont([p[0] for p in aff]).astype(np.uint16)
        Y = FP.to_mont([p[1] for p in aff]).astype(np.uint16)
        L = ints_to_limbs(ks).astype(np.uint16)
        os.makedirs(_VEC_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, X=X, Y=Y, L=L)
        os.replace(tmp, path)

    def dev(a):
        return torch.as_tensor(a.astype(np.int64), device=device)

    X, Y, L = dev(X), dev(Y), dev(L)
    Z = FP.ones_mont((X.shape[0],), device).contiguous()
    return X, Y, Z, L


def expected_key(log2n: int, seed: int = MSM_SEED) -> str:
    return f"msm_g1_seed{seed}_log{log2n}"


def load_expected(log2n: int, seed: int = MSM_SEED):
    """Committed (x, y) affine ints for the bench MSM, or None."""
    if not os.path.exists(EXPECTED_PATH):
        return None
    with open(EXPECTED_PATH) as f:
        table = json.load(f)
    ent = table.get(expected_key(log2n, seed))
    if ent is None:
        return None
    return int(ent[0], 16), int(ent[1], 16)


def store_expected(log2n: int, xy, seed: int = MSM_SEED, *,
                   path: str) -> None:
    """Write one point into the table at ``path``, in the committed file's
    format. The path is required: the repository's ``bench_expected.json``
    is written by the JAX package's generator only."""
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    table[expected_key(log2n, seed)] = [hex(int(xy[0])), hex(int(xy[1]))]
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
