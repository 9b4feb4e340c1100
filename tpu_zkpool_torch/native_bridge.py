"""ctypes bridge to the repository's native C++ BN254 code (``native/bn254.cpp``).

The port's own copy of ``tpu_zkpool/native_bridge.py``. It compiles the shared
host source with g++ into the port's build directory
(``tpu_zkpool_torch/build/``, content-hashed name) at first use, reads the
source and never edits it or writes beside it, and raises if g++ fails.
Groth16 setup and ``benchvec`` use its fixed-base batches (split over the
host's cores); the tests and ``chip_smoke.py`` use its Pippenger MSMs as the
oracle of the grid MSM.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "bn254.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libbn254_{h[:16]}.so")


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++"] + _FLAGS + ["-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for name in ("g1_fixed_base_mul_batch", "g2_fixed_base_mul_batch"):
        getattr(lib, name).argtypes = [u64p, ctypes.c_size_t, u64p]
    for name in ("g1_mul_batch", "g1_msm", "g2_msm", "g2_mul_batch"):
        getattr(lib, name).argtypes = [u64p, u64p, ctypes.c_size_t, u64p]
    for name in ("g1_fixed_base_mul_batch", "g2_fixed_base_mul_batch",
                 "g1_mul_batch", "g1_msm", "g2_msm", "g2_mul_batch"):
        getattr(lib, name).restype = None
    _lib = lib
    return lib


_MASK256 = (1 << 256) - 1


def _scalars_to_u64(ks) -> np.ndarray:
    """Scalars -> uint64[n, 4] little-endian words, the low 256 bits of
    each (two's complement for a negative value)."""
    buf = b"".join((int(k) & _MASK256).to_bytes(32, "little") for k in ks)
    return np.frombuffer(buf, dtype="<u8").reshape(-1, 4).copy()


def _aff_to_u64(pts) -> np.ndarray:
    out = np.zeros((len(pts), 8), dtype=np.uint64)
    for i, p in enumerate(pts):
        if p is None:
            continue
        x, y = int(p[0]), int(p[1])
        for j in range(4):
            out[i, j] = (x >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
            out[i, 4 + j] = (y >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
    return out


def _u64_ints(arr, k: int) -> list:
    """uint64[n, 4 k] rows -> per row, its k 256-bit little-endian ints."""
    buf = np.ascontiguousarray(arr, dtype="<u8").tobytes()
    frm = int.from_bytes
    return [tuple(frm(buf[o + 32 * j: o + 32 * j + 32], "little")
                  for j in range(k)) for o in range(0, len(buf), 32 * k)]


def _u64_to_aff(arr) -> list:
    return [None if x == 0 and y == 0 else (x, y)
            for x, y in _u64_ints(arr, 2)]


def _u64_to_g2(arr) -> list:
    return [None if not any(c) else ((c[0], c[1]), (c[2], c[3]))
            for c in _u64_ints(arr, 4)]


def _fixed_base(name: str, ks, words: int) -> np.ndarray:
    """[k_i] of the generator through ``name`` (a native fixed-base batch),
    the batch split over ``os.cpu_count()`` threads: ctypes releases the
    GIL during each call, and every call reads the generator's table only.
    A first call of no scalars builds that table before the threads share
    it. Returns the native output rows uint64[n, words]."""
    fn = getattr(get_lib(), name)
    sc = _scalars_to_u64(ks)
    n = len(sc)
    out = np.zeros((n, words), dtype=np.uint64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    fn(sc.ctypes.data_as(u64p), 0, out.ctypes.data_as(u64p))
    parts = max(1, min(os.cpu_count() or 1, n))
    cuts = [n * i // parts for i in range(parts + 1)]

    def run(lo, hi):
        fn(sc[lo:hi].ctypes.data_as(u64p), hi - lo,
           out[lo:hi].ctypes.data_as(u64p))

    with ThreadPoolExecutor(parts) as ex:
        list(ex.map(run, cuts[:-1], cuts[1:]))
    return out


def g1_gen_mul_batch(ks) -> list:
    """[k_i]G1 for many scalars (fixed-base windowed, native, threaded)."""
    return _u64_to_aff(_fixed_base("g1_fixed_base_mul_batch", ks, 8))


def g2_gen_mul_batch(ks) -> list:
    """[k_i]G2 for many scalars (fixed-base windowed, native, threaded)."""
    return _u64_to_g2(_fixed_base("g2_fixed_base_mul_batch", ks, 16))


def g1_mul_batch(ks, points) -> list:
    """[k_i]P_i elementwise (native)."""
    lib = get_lib()
    sc = _scalars_to_u64(ks)
    pts = _aff_to_u64(points)
    out = np.zeros((len(ks), 8), dtype=np.uint64)
    lib.g1_mul_batch(
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(ks),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return _u64_to_aff(out)


def g1_msm(ks, points):
    """Single Pippenger MSM (native)."""
    lib = get_lib()
    sc = _scalars_to_u64(ks)
    pts = _aff_to_u64(points)
    out = np.zeros((8,), dtype=np.uint64)
    lib.g1_msm(
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(ks),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return _u64_to_aff(out[None])[0]


def _g2_to_u64(pts) -> np.ndarray:
    out = np.zeros((len(pts), 16), dtype=np.uint64)
    for i, p in enumerate(pts):
        if p is None:
            continue
        (x0, x1), (y0, y1) = p
        for k, v in enumerate((x0, x1, y0, y1)):
            v = int(v)
            for j in range(4):
                out[i, 4 * k + j] = (v >> (64 * j)) & 0xFFFFFFFFFFFFFFFF
    return out


def g2_mul_batch(ks, points) -> list:
    lib = get_lib()
    sc = _scalars_to_u64(ks)
    pts = _g2_to_u64(points)
    out = np.zeros((len(ks), 16), dtype=np.uint64)
    lib.g2_mul_batch(
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(ks),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return _u64_to_g2(out)


def g2_msm(ks, points):
    lib = get_lib()
    sc = _scalars_to_u64(ks)
    pts = _g2_to_u64(points)
    out = np.zeros((16,), dtype=np.uint64)
    lib.g2_msm(
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(ks),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return _u64_to_g2(out[None])[0]
