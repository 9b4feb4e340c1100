"""Native CSR row evaluation and witness packing for the Groth16 prover.

The port's own copy of the CSR half of ``tpu_zkpool/groth16/solver_native.py``
(``get_lib``, ``ints_to_u64x4``, ``to_mont_batch``, ``eval_rows_native``);
the ACIR replay is not copied. It binds two functions of the shared host
source ``native/witness.cpp``: ``fr_eval_rows``, a sparse Fr matvec over a
plain uint64[n, 4] witness, and ``fr_to_mont_batch``.

``get_lib`` compiles the source with g++ into the port's build directory
(``tpu_zkpool_torch/build/``, content-hashed name) at first use, as
``native_bridge`` does with ``native/bn254.cpp``: it reads the source and
never edits it or writes beside it. It raises if g++ fails. Unlike the JAX
prover (``prove_tpu.py:325``), the port has no silent Python fallback for
the row evaluations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from tpu_zkpool_torch.fields.bn254 import FR_MOD as P
from tpu_zkpool_torch.native_bridge import BUILD_DIR

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "witness.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None


def lib_path() -> str:
    """The shared library of ``native/witness.cpp`` for the current source."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"libwitness_{h[:16]}.so")


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++"] + _FLAGS + ["-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.fr_eval_rows.argtypes = [i64p, i64p, u64p, ctypes.c_size_t,
                                 u64p, u64p]
    lib.fr_eval_rows.restype = None
    lib.fr_to_mont_batch.argtypes = [u64p, ctypes.c_size_t, u64p]
    lib.fr_to_mont_batch.restype = None
    _lib = lib
    return lib


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def ints_to_u64x4(vals) -> np.ndarray:
    """list of canonical ints -> uint64[n, 4] little-endian. Viewed as
    uint32 words it is ``fields.limbs.pack_limbs16`` of the ints' limbs."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u8").reshape(len(vals), 4).copy()


def to_mont_batch(arr: np.ndarray) -> np.ndarray:
    """Plain uint64[n, 4] Fr values -> Montgomery (R = 2^256)."""
    out = np.empty_like(arr)
    get_lib().fr_to_mont_batch(_u64p(arr), arr.shape[0], _u64p(out))
    return out


# cache_key -> (rows, CSR arrays); the rows object is held so that a key
# built from id(rows' owner) cannot name another circuit's rows
_csr_cache: dict = {}


def eval_rows_native(cache_key, rows, w_u64: np.ndarray) -> np.ndarray:
    """Evaluate sparse Fr rows (list of {var: coeff} dicts) against a plain
    uint64[n, 4] witness -> uint64[nrows, 4] plain values. The CSR arrays
    (coefficients in Montgomery form) build once per ``cache_key``."""
    hit = _csr_cache.get(cache_key)
    if hit is None or hit[0] is not rows:
        indptr = np.zeros(len(rows) + 1, dtype=np.int64)
        idx, coeffs = [], []
        for r, row in enumerate(rows):
            for v, c in row.items():
                idx.append(v)
                coeffs.append(c % P)
            indptr[r + 1] = len(idx)
        indices = np.asarray(idx, dtype=np.int64)
        if indices.size and indices.min() < 0:
            raise ValueError("eval_rows_native: a negative variable index")
        cf = to_mont_batch(ints_to_u64x4(coeffs)) if coeffs else \
            np.zeros((0, 4), dtype=np.uint64)
        nvars = int(indices.max()) + 1 if indices.size else 0
        hit = (rows, (indptr, indices, cf, nvars))
        _csr_cache[cache_key] = hit
    indptr, indices, cf, nvars = hit[1]
    if w_u64.shape[0] < nvars:
        raise ValueError(f"eval_rows_native: the rows name variable "
                         f"{nvars - 1}, the witness has {w_u64.shape[0]}")
    w_u64 = np.ascontiguousarray(w_u64, dtype=np.uint64)
    out = np.empty((len(rows), 4), dtype=np.uint64)
    get_lib().fr_eval_rows(_i64p(indptr), _i64p(indices), _u64p(cf),
                           len(rows), _u64p(w_u64), _u64p(out))
    return out
