"""Wrappers of the grid-MSM CUDA kernels K1-K6 (``csrc/msm_grid.cu``).

The kernels build with ``nvcc`` at first use into ``tpu_zkpool_torch/build/``
(a plain-C shared library, loaded with ctypes; ``cuda_build.py``) and launch
on the current CUDA stream. Each wrapper:

- sends a CPU tensor to the kernel's plain twin in ``msm/grid.py``;
- checks a CUDA tensor's dtype, shape and contiguity and raises on anything
  the kernel does not take;
- allocates the output with ``torch.empty``, launches, raises if the launch
  reported an error, and adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_zkpool_torch import cuda_build
from tpu_zkpool_torch.msm import grid

SOURCE = "msm_grid.cu"

# Launches per kernel since the last reset (the main path's evidence that
# it ran through the kernels).
LAUNCHES = dict.fromkeys(
    ("prefix_rows", "prefix", "wsum", "addn", "scale_add", "horner"), 0)

_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(extra_flags=()) -> tuple:
    """Compile the kernels unless the library for these sources exists.
    Returns (path, nvcc output or None when cached)."""
    return cuda_build.build(SOURCE, extra_flags)


def _load():
    global _lib
    if _lib is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        _lib = cuda_build.load(SOURCE, dict(
            msm_prefix_rows=[P, P, P, I, I, I, I, I, P],
            msm_prefix=[P, P, I, I, I, I, I, I, I, P],
            msm_wsum=[P, P, I, I, I, I, I, P],
            msm_addn=[P, P, P, P, P, P, I, L, L, I, I, P],
            msm_scale_add=[P, P, P, I, I, I, P],
            msm_horner=[P, P, I, I, I, P]))
    return _lib


def _point_rows(name, t, ndim, C=3):
    if t.dim() != ndim or t.shape[-3] != C or t.shape[-1] != 16 \
            or t.shape[-2] not in (1, 2):
        raise ValueError(f"{name}: bad point-row shape {tuple(t.shape)}")
    return t.shape[-2]


def prefix_rows(xy, payload_t, complete: bool):
    """K1, every window in one launch. xy (N, 2, ncomp, 16) affine source
    rows, payload_t (W, k, lanes) int64 index | neg << 31 (each index < N)
    -> (W, k * lanes, 3, ncomp, 16) per-lane inclusive prefixes in sorted
    order (row l * k + j = step j of lane l)."""
    # shapes are checked on the CPU as on the card
    nc = _point_rows("prefix_rows", xy, 4, C=2)
    if payload_t.dim() != 3 or payload_t.dtype != torch.int64:
        raise ValueError(f"prefix_rows: payload {payload_t.dtype} "
                         f"{tuple(payload_t.shape)}, want int64 (W, k, lanes)")
    if xy.shape[0] > 1 << 31:
        raise ValueError(f"prefix_rows: {xy.shape[0]} rows; the payload "
                         "indexes at most 2^31")
    if xy.device.type == "cpu":
        return grid.prefix_rows_plain(xy, payload_t, complete)
    cuda_build.check_tensors("prefix_rows", xy, payload_t)
    W, k, lanes = payload_t.shape
    out = torch.empty((W, k * lanes, 3, nc, 16), dtype=torch.int64,
                      device=xy.device)
    cuda_build.launch(LAUNCHES, "prefix_rows", out.device,
                      _load().msm_prefix_rows, xy.data_ptr(),
                      payload_t.data_ptr(), out.data_ptr(), W, k, lanes, nc,
                      int(complete))
    return out


def prefix(tiles, mixed: bool, complete: bool):
    """K2. tiles (k, lanes, C, ncomp, 16), C = 2 when ``mixed`` (affine
    input, mixed segment adds) else 3 (Jacobian, complete adds only) -> (k,
    lanes, 3, ncomp, 16) inclusive prefix sums, one warp a lane on the
    schedule of ``grid.prefix_schedule(k)``. ``complete`` sets the segment
    adds' doubling branch; the scan and carry adds are always complete."""
    if tiles.device.type == "cpu":
        return grid.prefix_plain(tiles, mixed, complete)
    cuda_build.check_tensors("prefix", tiles)
    nc = _point_rows("prefix", tiles, 5, C=2 if mixed else 3)
    if not mixed and not complete:
        raise ValueError("prefix: the Jacobian scan takes complete adds only")
    k, lanes = tiles.shape[:2]
    T, log2s = grid.prefix_schedule(k)
    out = torch.empty((k, lanes, 3, nc, 16), dtype=torch.int64,
                      device=tiles.device)
    cuda_build.launch(LAUNCHES, "prefix", out.device, _load().msm_prefix,
                      tiles.data_ptr(), out.data_ptr(), k, lanes, nc,
                      int(mixed), int(complete), T, log2s)
    return out


def wsum(steps):
    """K3. steps (L, lanes, 3, ncomp, 16) -> (2, lanes, 3, ncomp, 16):
    [sum_l B_l, sum_l (l + 1) B_l], one warp a lane on the schedule of
    ``grid.wsum_schedule(L)``."""
    if steps.device.type == "cpu":
        return grid.wsum_plain(steps)
    cuda_build.check_tensors("wsum", steps)
    nc = _point_rows("wsum", steps, 5)
    L, lanes = steps.shape[:2]
    T, log2s = grid.wsum_schedule(L)
    out = torch.empty((2, lanes, 3, nc, 16), dtype=torch.int64,
                      device=steps.device)
    cuda_build.launch(LAUNCHES, "wsum", out.device, _load().msm_wsum,
                      steps.data_ptr(), out.data_ptr(), L, lanes, nc, T,
                      log2s)
    return out


def _rows_index(name, idx, n):
    if idx is not None and (idx.dim() != 1 or idx.dtype != torch.int64
                            or idx.shape[0] != n):
        raise ValueError(f"{name}: want int64 ({n},), got {idx.dtype} "
                         f"{tuple(idx.shape)}")


def addn(a, b, ia=None, ib=None, neg_b=False, zero=None):
    """K4. Row-parallel complete Jacobian add over (., 3, ncomp, 16) rows:

        out[i] = a row of zeros          where zero[i]
               = A(i) + B(i)             elsewhere
        A(i)   = a[ia[i]] (a row of zeros where ia[i] < 0), or a[i]
        B(i)   = likewise from b and ib, then Y -> p - Y if ``neg_b``

    ``ia`` and ``ib`` are int64 (n,), ``zero`` bool (n,), each index below
    its source's row count; n is their length, else a's (and b's) rows.
    ``addn(a, b)`` is the Pallas ``_add_tiles``'s function."""
    n = next((t.shape[0] for t in (ia, ib, zero) if t is not None),
             a.shape[0])
    _rows_index("addn", ia, n)
    _rows_index("addn", ib, n)
    if zero is not None and (zero.dtype != torch.bool
                             or tuple(zero.shape) != (n,)):
        raise ValueError(f"addn: zero must be bool ({n},), got "
                         f"{zero.dtype} {tuple(zero.shape)}")
    nc = _point_rows("addn", a, 4)
    if _point_rows("addn", b, 4) != nc or (ia is None and a.shape[0] != n) \
            or (ib is None and b.shape[0] != n):
        raise ValueError(f"addn: shapes {tuple(a.shape)}, {tuple(b.shape)} "
                         f"for {n} rows")
    if a.device.type == "cpu":
        return grid.addn_plain(a, b, ia, ib, neg_b, zero)
    cuda_build.check_tensors("addn", a, b,
                             *[t for t in (ia, ib) if t is not None])
    if zero is not None:
        cuda_build.check_tensors("addn", zero, dtype=torch.bool)
        if zero.device != a.device:
            raise ValueError(f"addn: zero on {zero.device}, rows on "
                             f"{a.device}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("addn: rows must start on a 16-byte boundary")
    out = torch.empty((n,) + a.shape[1:], dtype=torch.int64, device=a.device)
    if n == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()
    cuda_build.launch(LAUNCHES, "addn", out.device, _load().msm_addn,
                      a.data_ptr(), b.data_ptr(), ptr(ia), ptr(ib),
                      ptr(zero), out.data_ptr(), n, a.shape[0], b.shape[0],
                      nc, int(neg_b))
    return out


def scale_add(a, b, log2s: int):
    """K5. Row-parallel 2^log2s * a + b on (n, 3, ncomp, 16): log2s
    doublings, then one complete add; one warp a row."""
    if a.device.type == "cpu":
        return grid.scale_add_plain(a, b, log2s)
    cuda_build.check_tensors("scale_add", a, b)
    nc = _point_rows("scale_add", a, 4)
    if a.shape != b.shape:
        raise ValueError(f"scale_add: shapes {tuple(a.shape)} != "
                         f"{tuple(b.shape)}")
    out = torch.empty_like(a)
    if a.shape[0] == 0:
        return out
    cuda_build.launch(LAUNCHES, "scale_add", out.device,
                      _load().msm_scale_add, a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), a.shape[0], nc, int(log2s))
    return out


def horner(S, c: int):
    """K6. S (W, 3, ncomp, 16) window sums, W >= 1 -> sum_w 2^(c w) S_w as
    one row (3, ncomp, 16), by Horner's rule in one thread."""
    if S.device.type == "cpu":
        return grid.horner_plain(S, c)
    cuda_build.check_tensors("horner", S)
    nc = _point_rows("horner", S, 4)
    out = torch.empty(S.shape[1:], dtype=torch.int64, device=S.device)
    cuda_build.launch(LAUNCHES, "horner", out.device, _load().msm_horner,
                      S.data_ptr(), out.data_ptr(), S.shape[0], nc, int(c))
    return out
