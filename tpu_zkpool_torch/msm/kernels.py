"""Wrappers of the grid-MSM CUDA kernels K1-K6 (``csrc/msm_grid.cu``).

The kernels build with ``nvcc`` at first use into ``tpu_zkpool_torch/build/``
(a plain-C shared library, loaded with ctypes) and launch on the current
CUDA stream. Each wrapper:

- sends a CPU tensor to the kernel's plain twin in ``msm/grid.py``;
- checks a CUDA tensor's dtype, shape and contiguity and raises on anything
  the kernel does not take;
- allocates the output with ``torch.empty``, launches, raises if the launch
  reported an error, and adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from tpu_zkpool_torch.msm import grid

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("field.cuh", "point.cuh", "msm_grid.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# Launches per kernel since the last reset (the main path's evidence that
# it ran through the kernels).
LAUNCHES = dict.fromkeys(
    ("prefix_rows", "prefix", "wsum", "addn", "scale_add", "horner"), 0)

_lib = None


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path() -> str:
    """The shared library for the current sources (content-hashed name)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmsm_grid_{h.hexdigest()[:16]}.so")


def build(extra_flags=()) -> tuple:
    """Compile the kernels unless the library for these sources exists.
    Returns (path, nvcc output or None when cached)."""
    path = library_path()
    if os.path.exists(path):
        return path, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ([_nvcc()] + NVCC_FLAGS + list(extra_flags)
           + ["-o", tmp, os.path.join(CSRC, "msm_grid.cu")])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)
    return path, res.stdout + res.stderr


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build()[0])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.msm_prefix_rows.argtypes = [P, P, P, I, I, I, I, P]
    lib.msm_prefix.argtypes = [P, P, I, I, I, I, I, P]
    lib.msm_wsum.argtypes = [P, P, I, I, I, P]
    lib.msm_addn.argtypes = [P, P, P, I, I, P]
    lib.msm_scale_add.argtypes = [P, P, P, I, I, I, P]
    lib.msm_horner.argtypes = [P, P, I, I, I, P]
    for fn in (lib.msm_prefix_rows, lib.msm_prefix, lib.msm_wsum,
               lib.msm_addn, lib.msm_scale_add, lib.msm_horner):
        fn.restype = I
    _lib = lib
    return lib


def _check(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device, got {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous int64 tensors on one "
                             f"device, got {t.dtype} {t.device} "
                             f"contiguous={t.is_contiguous()}")


def _point_rows(name, t, ndim, C=3):
    if t.dim() != ndim or t.shape[-3] != C or t.shape[-1] != 16 \
            or t.shape[-2] not in (1, 2):
        raise ValueError(f"{name}: bad point-row shape {tuple(t.shape)}")
    return t.shape[-2]


def _launch(name, device, fn, *args):
    """Call launcher ``fn`` on ``device``'s current stream; raise on the
    error it returns, else count the launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1


def prefix_rows(rows_t, signs_t, complete: bool):
    """K1. rows_t (k, lanes, 2, ncomp, 16) step-major affine rows, signs_t
    (k, lanes) nonzero where Y negates -> (k, lanes, 3, ncomp, 16)."""
    if rows_t.device.type == "cpu":
        return grid.prefix_rows_plain(rows_t, signs_t, complete)
    _check("prefix_rows", rows_t, signs_t)
    nc = _point_rows("prefix_rows", rows_t, 5, C=2)
    k, lanes = rows_t.shape[:2]
    if tuple(signs_t.shape) != (k, lanes):
        raise ValueError(f"prefix_rows: signs shape {tuple(signs_t.shape)}")
    out = torch.empty((k, lanes, 3, nc, 16), dtype=torch.int64,
                      device=rows_t.device)
    _launch("prefix_rows", out.device, _load().msm_prefix_rows,
            rows_t.data_ptr(), signs_t.data_ptr(), out.data_ptr(), k, lanes,
            nc, int(complete))
    return out


def prefix(tiles, mixed: bool, complete: bool):
    """K2. tiles (k, lanes, C, ncomp, 16), C = 2 when ``mixed`` (affine
    input, mixed adds) else 3 (Jacobian, complete adds only) -> (k, lanes,
    3, ncomp, 16) inclusive prefix sums."""
    if tiles.device.type == "cpu":
        return grid.prefix_plain(tiles, mixed, complete)
    _check("prefix", tiles)
    nc = _point_rows("prefix", tiles, 5, C=2 if mixed else 3)
    if not mixed and not complete:
        raise ValueError("prefix: the Jacobian scan takes complete adds only")
    k, lanes = tiles.shape[:2]
    out = torch.empty((k, lanes, 3, nc, 16), dtype=torch.int64,
                      device=tiles.device)
    _launch("prefix", out.device, _load().msm_prefix, tiles.data_ptr(),
            out.data_ptr(), k, lanes, nc, int(mixed), int(complete))
    return out


def wsum(steps):
    """K3. steps (L, lanes, 3, ncomp, 16) -> (2, lanes, 3, ncomp, 16):
    [sum_l B_l, sum_l (l + 1) B_l]."""
    if steps.device.type == "cpu":
        return grid.wsum_plain(steps)
    _check("wsum", steps)
    nc = _point_rows("wsum", steps, 5)
    L, lanes = steps.shape[:2]
    out = torch.empty((2, lanes, 3, nc, 16), dtype=torch.int64,
                      device=steps.device)
    _launch("wsum", out.device, _load().msm_wsum, steps.data_ptr(),
            out.data_ptr(), L, lanes, nc)
    return out


def addn(a, b):
    """K4. Row-parallel complete Jacobian a + b on (n, 3, ncomp, 16)."""
    if a.device.type == "cpu":
        return grid.addn_plain(a, b)
    _check("addn", a, b)
    nc = _point_rows("addn", a, 4)
    if a.shape != b.shape:
        raise ValueError(f"addn: shapes {tuple(a.shape)} != {tuple(b.shape)}")
    out = torch.empty_like(a)
    _launch("addn", out.device, _load().msm_addn, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), a.shape[0], nc)
    return out


def scale_add(a, b, log2s: int):
    """K5. Row-parallel 2^log2s * a + b on (n, 3, ncomp, 16)."""
    if a.device.type == "cpu":
        return grid.scale_add_plain(a, b, log2s)
    _check("scale_add", a, b)
    nc = _point_rows("scale_add", a, 4)
    if a.shape != b.shape:
        raise ValueError(f"scale_add: shapes {tuple(a.shape)} != "
                         f"{tuple(b.shape)}")
    out = torch.empty_like(a)
    _launch("scale_add", out.device, _load().msm_scale_add, a.data_ptr(),
            b.data_ptr(), out.data_ptr(), a.shape[0], nc, int(log2s))
    return out


def horner(S, c: int):
    """K6. S (W, 3, ncomp, 16) window sums -> sum_w 2^(c w) S_w as one row
    (3, ncomp, 16)."""
    if S.device.type == "cpu":
        return grid.horner_plain(S, c)
    _check("horner", S)
    nc = _point_rows("horner", S, 4)
    out = torch.empty(S.shape[1:], dtype=torch.int64, device=S.device)
    _launch("horner", out.device, _load().msm_horner, S.data_ptr(),
            out.data_ptr(), S.shape[0], nc, int(c))
    return out
