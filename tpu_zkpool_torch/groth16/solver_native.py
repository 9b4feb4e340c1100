"""Native witness generation and CSR row evaluation for the Groth16 prover.

The port's copy of ``tpu_zkpool/groth16/solver_native.py``. It binds the
shared host source ``native/witness.cpp``:

- the CSR half: ``fr_eval_rows``, a sparse Fr matvec over a plain
  uint64[n, 4] witness, and ``fr_to_mont_batch`` (``eval_rows_native``,
  ``to_mont_batch``), which the prover's U/V/W rows and packing use;
- the ACIR half: the witness VM ``wp_create`` / ``wp_run`` /
  ``wp_destroy``. ``CompiledSolver`` traces one interpreter solve
  (``solver.solve(trace=)``; the schedule depends only on the circuit and
  the SET of input witness indices), lowers the schedule to the VM's flat
  arrays (an expression table and a record stream; the embedded-curve MSM
  and add are native records, and/xor/poseidon2 replay between native
  segments through the interpreter's ``_exec_blackbox``), and replays it
  per solve over one uint64[n, 4] witness buffer.

``get_lib`` compiles the source with g++ into the port's build directory
(``tpu_zkpool_torch/build/``, content-hashed name) at first use, as
``native_bridge`` does with ``native/bn254.cpp``: it reads the source and
never edits it or writes beside it. It raises if g++ fails: the row
evaluations have no Python fallback (the JAX prover's, ``prove_tpu.py:325``,
is silent).

Departures from the JAX module, each a fault of the copy's original:

- the module-level ``solve`` caches its ``CompiledSolver`` under the
  program's identity and holds the ``Program`` beside it, so a cached
  entry is never served for another program that reuses a freed object's
  ``id``;
- it falls back to the interpreter only on ``UnsupportedCircuit``, a limit
  of the lowering (or a replay that does not reproduce the traced solve);
  a failed g++ build or load raises instead of quietly solving in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from tpu_zkpool_torch.fields.bn254 import FR_MOD as P
from tpu_zkpool_torch.groth16 import solver as pysolver
from tpu_zkpool_torch.groth16.acir import Expression, Program
from tpu_zkpool_torch.native_bridge import BUILD_DIR
from tpu_zkpool_torch.utils.metrics import span

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
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [u64p, ctypes.c_size_t, i64p, ctypes.c_size_t,
                              i64p, ctypes.c_size_t, i64p, ctypes.c_size_t,
                              i64p, ctypes.c_size_t, i64p, ctypes.c_size_t,
                              ctypes.c_size_t]
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_destroy.restype = None
    lib.wp_run.restype = ctypes.c_long
    lib.wp_run.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                           u64p, ctypes.POINTER(ctypes.c_uint8)]
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


# --------------------------------------------------------- the ACIR replay

def _to_u64x4(x: int) -> list:
    return [(x >> (64 * j)) & 0xFFFFFFFFFFFFFFFF for j in range(4)]


def _from_u64x4(row) -> int:
    return (int(row[0]) | int(row[1]) << 64 | int(row[2]) << 128
            | int(row[3]) << 192)


class _Lowering:
    def __init__(self):
        self.pool_vals: list[int] = []
        self.pool_map: dict[int, int] = {}
        self.expr_rows: list[list[int]] = []
        self.mul_rows: list[list[int]] = []
        self.lin_rows: list[list[int]] = []
        self.stream: list[list[int]] = []
        self.outidx: list[int] = []

    def cidx(self, v: int) -> int:
        v %= P
        if v not in self.pool_map:
            self.pool_map[v] = len(self.pool_vals)
            self.pool_vals.append(v)
        return self.pool_map[v]

    def expr_row(self, mul_terms, linear, q_c) -> int:
        mo, lo = len(self.mul_rows), len(self.lin_rows)
        for c, a, b in mul_terms:
            self.mul_rows.append([self.cidx(c), a, b])
        for c, a in linear:
            self.lin_rows.append([self.cidx(c), a])
        self.expr_rows.append(
            [len(mul_terms), mo, len(linear), lo, self.cidx(q_c)])
        return len(self.expr_rows) - 1

    def rec(self, *fields):
        row = list(fields) + [0] * (8 - len(fields))
        self.stream.append(row)


class UnsupportedCircuit(Exception):
    """The lowering cannot express the circuit, or its replay does not
    reproduce the traced solve."""


class CompiledSolver:
    """One compiled witness program per (Program, input-index-set)."""

    def __init__(self, program: Program, example_inputs: dict[int, int]):
        trace: list = []
        ref = pysolver.solve(program, example_inputs, trace=trace)
        self.program = program
        self.n_witness = max(ref) + 1
        self.input_keys = sorted(example_inputs)
        low = _Lowering()
        self.segments: list[tuple[int, int]] = []   # (start, end) records
        self.callbacks: list = []                   # op between segments
        seg_start = 0

        for ev in trace:
            kind = ev[0]
            if kind == "gate":
                self._lower_gate(low, ev[1], ev[2])
            elif kind == "range":
                low.rec(1, ev[1], ev[2])
            elif kind == "brillig":
                self._lower_brillig(low, *ev[1:])
            elif kind == "callback":
                op = ev[1]
                if op.kind == "multi_scalar_mul":
                    self._lower_msm(low, op.data)
                elif op.kind == "embedded_curve_add":
                    self._lower_ecadd(low, op.data)
                else:
                    # and/xor/poseidon2: replay through the Python
                    # handler between native segments
                    self.segments.append((seg_start, len(low.stream)))
                    self.callbacks.append(op)
                    seg_start = len(low.stream)
            else:
                raise UnsupportedCircuit(f"trace event {kind}")
        self.segments.append((seg_start, len(low.stream)))

        pool = np.array([_to_u64x4(v) for v in low.pool_vals] or
                        [[0, 0, 0, 0]], dtype=np.uint64)
        a = (   # wp_create copies them
            pool,
            np.array(low.expr_rows or [[0] * 5], dtype=np.int64),
            np.array(low.mul_rows or [[0] * 3], dtype=np.int64),
            np.array(low.lin_rows or [[0] * 2], dtype=np.int64),
            np.array(low.stream or [[0] * 8], dtype=np.int64),
            np.array(low.outidx or [0], dtype=np.int64),
        )
        self._h = get_lib().wp_create(
            _u64p(a[0]), len(low.pool_vals), _i64p(a[1]), len(low.expr_rows),
            _i64p(a[2]), len(low.mul_rows), _i64p(a[3]), len(low.lin_rows),
            _i64p(a[4]), len(low.stream), _i64p(a[5]), len(low.outidx),
            self.n_witness)
        # self-check: the compiled program must reproduce the trace run
        # (a witness the lowering never assigns, such as a memory read's,
        # shows here as a mismatch or as a failed replay)
        try:
            got = self.solve(example_inputs)
        except pysolver.SolveError as e:
            raise UnsupportedCircuit(f"replay failed: {e}") from e
        if got != ref:
            diff = [k for k in ref if got.get(k) != ref[k]][:5]
            raise UnsupportedCircuit(f"replay mismatch at witnesses {diff}")

    # ------------------------------------------------------------ lowering

    def _lower_gate(self, low: _Lowering, expr: Expression, target):
        if target is None:
            ei = low.expr_row(expr.mul_terms, expr.linear, expr.q_c)
            low.rec(0, ei, -1, -1, -1)
            return
        known_mul, known_lin = [], []
        coeff_lin, coeff_const = [], 0
        for c, a, b in expr.mul_terms:
            if a == target and b == target:
                raise UnsupportedCircuit("quadratic solve target")
            if a == target:
                coeff_lin.append((c, b))
            elif b == target:
                coeff_lin.append((c, a))
            else:
                known_mul.append((c, a, b))
        for c, a in expr.linear:
            if a == target:
                coeff_const = (coeff_const + c) % P
            else:
                known_lin.append((c, a))
        ei = low.expr_row(known_mul, known_lin, expr.q_c)
        if not coeff_lin:
            if coeff_const % P == 0:
                raise UnsupportedCircuit("zero static solve coefficient")
            inv = pow(coeff_const, -1, P)
            low.rec(0, ei, -1, low.cidx(inv), target)
        else:
            ci = low.expr_row([], coeff_lin, coeff_const)
            low.rec(0, ei, ci, -1, target)

    def _lower_brillig(self, low: _Lowering, name, payloads, outputs):
        def expr_of(pl):
            return low.expr_row(pl.mul_terms, pl.linear, pl.q_c)

        if name == "directive_integer_quotient":
            (kq, oq), (kr, orr) = outputs
            if not kq == kr == "simple":
                raise UnsupportedCircuit("integer quotient into an array")
            low.rec(2, expr_of(payloads[0]), expr_of(payloads[1]), oq, orr)
        elif name == "directive_invert":
            (k0, out), = outputs
            if k0 != "simple":
                raise UnsupportedCircuit("inverse into an array")
            low.rec(3, expr_of(payloads[0]), out)
        elif name in ("directive_to_le_radix", "directive_to_radix"):
            radix_pl = payloads[1]
            if radix_pl.mul_terms or radix_pl.linear:
                raise UnsupportedCircuit("non-constant radix")
            radix = radix_pl.q_c % P
            if not (2 <= radix < (1 << 64)):
                raise UnsupportedCircuit(f"radix {radix}")
            (k0, outs), = outputs
            if k0 != "array":
                raise UnsupportedCircuit("radix digits into a simple output")
            off = len(low.outidx)
            low.outidx.extend(outs)
            low.rec(4, expr_of(payloads[0]), radix, off, len(outs))
        else:
            raise UnsupportedCircuit(f"brillig {name}")

    @staticmethod
    def _fi(low: _Lowering, fi) -> list:
        kind, v = fi
        if kind == "const":
            return [1, low.cidx(v)]
        return [0, v]

    def _lower_msm(self, low: _Lowering, d):
        pts, scs = d["points"], d["scalars"]
        nterms = len(pts) // 3
        off = len(low.outidx)
        for t in range(nterms):
            for fi in pts[3 * t: 3 * t + 3]:
                low.outidx.extend(self._fi(low, fi))
            for fi in scs[2 * t: 2 * t + 2]:
                low.outidx.extend(self._fi(low, fi))
        ox, oy, oinf = d["out"]
        low.rec(5, nterms, off, ox, oy, oinf)

    def _lower_ecadd(self, low: _Lowering, d):
        off = len(low.outidx)
        for fi in d["in"]:
            low.outidx.extend(self._fi(low, fi))
        ox, oy, oinf = d["out"]
        low.rec(6, off, ox, oy, oinf)

    # ------------------------------------------------------------- replay

    def solve_raw(self, inputs: dict[int, int]):
        """Solve into the flat buffers: (witness uint64[n, 4] plain LE,
        known uint8[n]). The zero-bigint path for batch proving."""
        lib = get_lib()
        wit = np.zeros((self.n_witness, 4), dtype=np.uint64)
        known = np.zeros(self.n_witness, dtype=np.uint8)
        for k, v in inputs.items():
            if not 0 <= k < self.n_witness:
                raise ValueError(f"input witness {k} outside the circuit's "
                                 f"{self.n_witness}")
            wit[k] = _to_u64x4(v % P)
            known[k] = 1
        wp, kp = _u64p(wit), known.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8))
        for i, (s, e) in enumerate(self.segments):
            rc = lib.wp_run(self._h, s, e, wp, kp)
            if rc != 0:
                code, idx = divmod(rc, 1000000)
                raise pysolver.SolveError(
                    f"native solve failed: code {code} at record {idx}")
            if i < len(self.callbacks):
                pysolver._exec_blackbox(self.callbacks[i],
                                        _WitView(wit, known))
        return wit, known

    def solve(self, inputs: dict[int, int]) -> dict[int, int]:
        if sorted(inputs) != self.input_keys:
            raise ValueError(
                "input witness set differs from the compiled schedule")
        wit, known = self.solve_raw(inputs)
        return {i: _from_u64x4(wit[i])
                for i in range(self.n_witness) if known[i]}

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and _lib is not None:
            _lib.wp_destroy(h)


class _WitView:
    """dict-like int view over the native witness buffer for blackboxes."""

    def __init__(self, wit, known):
        self._w, self._k = wit, known

    def __contains__(self, i):
        return bool(self._k[i])

    def __getitem__(self, i):
        if not self._k[i]:
            raise KeyError(i)
        return _from_u64x4(self._w[i])

    def __setitem__(self, i, v):
        self._w[i] = _to_u64x4(int(v) % P)
        self._k[i] = 1


# (id(program), input keys) -> (program, CompiledSolver or None); the
# program is held so that its id cannot name another program while cached
_cache: dict = {}


def solve(program: Program, inputs: dict[int, int]) -> dict[int, int]:
    """Drop-in for ``solver.solve``: compiles on the first call per program
    and input set, replays natively afterwards. A circuit the lowering
    cannot express (``UnsupportedCircuit``) is solved by the interpreter;
    any other failure, a g++ build included, raises. The span
    ``witness.solve`` covers the call."""
    with span("witness.solve"):
        key = (id(program), tuple(sorted(inputs)))
        hit = _cache.get(key)
        if hit is None or hit[0] is not program:
            try:
                cs = CompiledSolver(program, inputs)
            except UnsupportedCircuit:
                cs = None
            hit = (program, cs)
            _cache[key] = hit
        cs = hit[1]
        if cs is None:
            return pysolver.solve(program, inputs)
        return cs.solve(inputs)
