"""Groth16 proving with the MSMs and H(X) on the GPU (the port of
``tpu_zkpool/groth16/prove_tpu.py``).

The four G1 legs (A, B1, K, H) and the G2 leg (B2) run through the grid
Pippenger MSM (``msm.grid``, CUDA kernels K1-K6, and K8 for the G1 legs
with ``tree=True``); H(X) = (UV - W)/t runs through the Fr NTT
(``groth16.domain``: P4 passes of up to 11 stages, the coset quotient and
the demont step fused into the coset inverse's passes) and P5's
Montgomery step of the evaluations (``groth16.ntt_kernels``). The U/V/W
row evaluations are host work in C++ (``solver_native.eval_rows_native``
over ``native/witness.cpp``), the witness and the K-leg scalars are packed
by ``solver_native.ints_to_u64x4``, and the final combine into (A, B2, C)
is host bigint code. A proof equals
``tpu_zkpool.refimpl.groth16_ref.prove`` on the same inputs and seed.

Each proof's phases are spans of ``utils.metrics`` (annotations of any
torch.profiler profile that runs), with the same boundaries in ``prove``
and ``prove_batch``: ``prove.dispatch`` holds ``prove.pack_witness``,
``prove.upload``, ``msm.a``, ``msm.b1``, ``msm.b2``, ``prove.h_ntt``
(``prove.h_rows`` inside it), ``msm.h`` and ``msm.k``; then
``prove.fetch`` and ``prove.combine``. Their roots are ``prove.proof`` and
``prove.batch``.
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch

from tpu_zkpool_torch import resolve_device
from tpu_zkpool_torch.fields.bn254 import FR_MOD as R
from tpu_zkpool_torch.fields.fctx import FP, FR
from tpu_zkpool_torch.fields.limbs import NLIMB, int_to_limbs, unpack_limbs16
from tpu_zkpool_torch.groth16 import domain
from tpu_zkpool_torch.groth16 import ntt_kernels as nk
from tpu_zkpool_torch.groth16 import solver_native as sn
from tpu_zkpool_torch.msm import grid
from tpu_zkpool_torch.msm.grid import TILE_N, msm_grid_g1, msm_grid_g2
from tpu_zkpool_torch.refimpl import groth16_ref as g16
from tpu_zkpool_torch.refimpl import pairing_ref as pr
from tpu_zkpool_torch.utils.metrics import span

# Limb arrays go to the device packed (two 16-bit limbs per word,
# fields.limbs.pack_limbs16) and unpack there: half the bytes of every
# upload (witness, H evaluations, proving-key queries).


def _unpack_dev(packed: np.ndarray, device) -> torch.Tensor:
    """Packed uint32[..., 8] host words -> int64[..., 16] limbs on device."""
    return unpack_limbs16(torch.as_tensor(packed.astype(np.int64),
                                          device=device))


_R2_FR = (1 << 512) % R          # R^2 mod r with R = 2^256


def _unpack_mont_fr(packed: np.ndarray, device) -> torch.Tensor:
    """Packed plain Fr words -> Montgomery limbs on device:
    mont_mul(x, R^2) = x R (P5 in place on a CUDA device)."""
    r2 = torch.as_tensor(int_to_limbs(_R2_FR), device=device)
    x = _unpack_dev(packed, device)
    return nk.pointwise(x, r2, out=x)


def _pad_up(n: int, lanes: int = TILE_N) -> int:
    """Pad a point count to the lane width and, beyond one sub-MSM slice,
    to a multiple of the slice size (so ``window_sums`` folds slices).
    Padding rows are identities (Z = 0), routed to the never-read
    bucket 0."""
    npad = max(lanes, -(-n // lanes) * lanes)
    sub = 1 << grid.SUB_LOG2
    if npad > sub:
        npad = -(-npad // sub) * sub
    return npad


_R2_FP = (1 << 512) % pr.P      # R^2 mod p with R = 2^256
_MONT_ROWS = 1 << 18            # rows a Montgomery conversion on the device


def _fp_mont_dev(vals: list, device) -> torch.Tensor:
    """Plain Fp ints (< p) -> Montgomery limbs int64[n, 16] on device. Each
    value goes up as its packed words (``int.to_bytes``); the device takes
    mont_mul(x, R^2) = x R, ``_MONT_ROWS`` rows at a time, the same limbs as
    ``FP.to_mont``."""
    packed = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                           dtype="<u4").reshape(-1, NLIMB // 2)
    r2 = torch.as_tensor(int_to_limbs(_R2_FP), device=device)
    return torch.cat([FP.mont_mul(_unpack_dev(packed[s:s + _MONT_ROWS],
                                              device), r2)
                      for s in range(0, len(packed), _MONT_ROWS)])


def _identity_mask(pts: list, npad: int, device) -> torch.Tensor:
    """int64[npad]: 1 where a point is given, 0 for None and the padding."""
    mask = np.zeros(npad, dtype=np.int64)
    mask[: len(pts)] = [p is not None for p in pts]
    return torch.as_tensor(mask, device=device)


def _points_device(pts: list, device, npad: int):
    """Affine G1 int points (None allowed) -> Jacobian (X, Y, Z) limbs
    int64[npad, 16] on device, identity-padded (Z = 0)."""
    pad = [0] * (npad - len(pts))
    X = _fp_mont_dev([p[0] if p else 0 for p in pts] + pad, device)
    Y = _fp_mont_dev([p[1] if p else 0 for p in pts] + pad, device)
    zmask = _identity_mask(pts, npad, device)
    Z = FP.ones_mont((npad,), device) * zmask[:, None]
    return X, Y, Z


def _points_device_g2(pts: list, device, npad: int):
    """Affine G2 points ((x0, x1), (y0, y1)) -> (X, Y, Z) int64[npad, 2, 16]."""
    pad = [0] * (2 * (npad - len(pts)))

    def comp(i):
        vals = [v for p in pts for v in (p[i] if p else (0, 0))] + pad
        return _fp_mont_dev(vals, device).reshape(npad, 2, NLIMB)

    X, Y = comp(0), comp(1)
    zmask = _identity_mask(pts, npad, device)
    one = FP.ones_mont((npad,), device) * zmask[:, None]
    Z = torch.stack([one, torch.zeros_like(one)], 1)   # Z = 1 + 0u (or 0)
    return X, Y, Z


def _scalar_limbs(w64: np.ndarray, npad: int, device) -> torch.Tensor:
    """Plain scalars as uint64[n, 4] (``solver_native.ints_to_u64x4``) ->
    limbs int64[npad, 16] on device (zero-padded). The u64x4 rows viewed as
    uint32 words are the packed wire format of ``_unpack_dev``."""
    pad = np.zeros((npad, NLIMB // 2), dtype=np.uint32)
    pad[: len(w64)] = w64.view("<u4")
    return _unpack_dev(pad, device)


class DeviceProvingKey:
    """Device-resident query points (G1 and G2) plus the host pk.

    ``complete=False`` (prover mode) drops the doubling branch of the
    input-point scan: safe for large pseudorandom query sets, not for tiny
    or structured circuits, so it defaults to complete. Small G1 legs are
    unified to one padded size; ``pad_to`` forces every leg (G2 included)
    to one size. ``lanes`` is the MSM chunk count (a multiple of 32).
    ``tree`` runs the four G1 legs through the batched-affine bucket tree
    (kernel K8); the G2 leg keeps the prefix path."""

    def __init__(self, pk: g16.ProvingKey, c: int = 13,
                 complete: bool = True, tree: bool = False,
                 pad_to: int = 0, lanes: int = TILE_N, device=None):
        self.pk = pk
        self.c = c
        self.complete = complete
        self.tree = tree
        self.lanes = lanes
        self.device = resolve_device(device)
        npads = [_pad_up(len(q), lanes) for q in
                 (pk.a_query, pk.b1_query, pk.k_query, pk.h_query)]
        unified = max(npads) if max(npads) <= (1 << grid.SUB_LOG2) else 0
        if pad_to:
            if pad_to < max(npads):
                raise ValueError(f"pad_to={pad_to} is below a leg's "
                                 f"padded size {max(npads)}")
            unified = pad_to

        def size(q):
            return max(_pad_up(len(q), lanes), unified)

        dev = self.device
        self._na = size(pk.a_query)
        self._nk = size(pk.k_query)
        self._nh = size(pk.h_query)
        self._nb2 = max(_pad_up(len(pk.b2_query), lanes), pad_to)
        self.a_query = _points_device(pk.a_query, dev, self._na)
        self.b1_query = _points_device(pk.b1_query, dev, size(pk.b1_query))
        self.k_query = _points_device(pk.k_query, dev, self._nk)
        self.h_query = _points_device(pk.h_query, dev, self._nh)
        self.b2_query = _points_device_g2(pk.b2_query, dev, self._nb2)

    def _msm_g1(self, points_dev, npad, limbs):
        return msm_grid_g1(points_dev, limbs[:npad].contiguous(), c=self.c,
                           lanes=self.lanes, complete=self.complete,
                           tree=self.tree)

    def _msm_g2(self, limbs):
        return msm_grid_g2(self.b2_query, limbs[: self._nb2].contiguous(),
                           c=self.c, lanes=self.lanes, complete=self.complete)


def _g1_affine(out):
    """(X, Y, Z) limb rows -> affine int point (None for the identity)."""
    x, y, z = (int(FP.from_mont(t)) for t in out)
    if z == 0:
        return None
    P = pr.P
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _g2_affine(out):
    """(X, Y, Z) Fp2 Jacobian limb rows (2, 16) each -> affine int pairs."""
    X, Y, Z = (tuple(int(v) for v in FP.from_mont(t)) for t in out)
    if Z == (0, 0):
        return None
    zi = pr.f2_inv(Z)
    zi2 = pr.f2_mul(zi, zi)
    return (pr.f2_mul(X, zi2), pr.f2_mul(Y, pr.f2_mul(zi2, zi)))


# The key of ``prove(timings=)`` each phase's seconds add to: packing and
# upload are "upload", the fetch and the combine "combine".
_TIMING_KEY = {"prove.pack_witness": "upload", "prove.upload": "upload",
               "msm.a": "msm_a", "msm.b1": "msm_b1", "msm.b2": "msm_b2",
               "prove.h_ntt": "h_ntt", "prove.h_rows": "h_rows",
               "msm.h": "msm_h", "msm.k": "msm_k",
               "prove.fetch": "combine", "prove.combine": "combine"}


def _phase(timings, name, device):
    """The span of one prover phase. With ``timings`` a dict, the device is
    synchronized at both ends of the phase and its seconds are added to
    ``timings[_TIMING_KEY[name]]``."""
    if timings is None:
        return span(name)
    return _timed_phase(timings, name, device)


@contextlib.contextmanager
def _timed_phase(timings, name, device):
    with span(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        key = _TIMING_KEY[name]
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0


def _h_pipeline(evs, tinv, tables, demont):
    """(3, n, 16) Montgomery evaluations of U, V, W -> H coefficients.
    Every intermediate stays in the Montgomery domain: mont_mul(U R, V R)
    = U V R. ``demont`` returns plain limbs (mont_mul(h R, 1) = h)."""
    coeffs = domain.interpolate_natural(evs, tables["br"], tables["inv"],
                                        tables["ninv"])
    on_coset = domain.coset_forward(coeffs, tables["coset"], tables["fwd"])
    return _h_finish(on_coset[0], on_coset[1], on_coset[2], tinv, tables,
                     demont)


def _h_finish(a_ev, b_ev, c_ev, tinv, tables, demont):
    """(A B - C) t^-1 on the coset, read by the coset inverse NTT itself
    (its first P4 pass on the kernel route), and with ``demont`` the step
    mont_mul(h R, 1) = h folded into its n^-1: mont_mul(x, n^-1) =
    mont_mul(mont_mul(x, n^-1 R), 1)."""
    ninv = tables["ninv_demont"] if demont else tables["ninv"]
    return domain.coset_inverse(a_ev, tables["coset_inv"], tables["inv"],
                                ninv, quotient=(b_ev, c_ev, tinv))


# Above this domain size the H pipeline runs one polynomial at a time
# (a third of the peak memory, a few more launches).
_H_SPLIT_MIN_N = 1 << 20


def _h_pipeline_split(evs, tinv, tables, demont):
    on_coset = []
    for i in range(3):
        coeffs = domain.interpolate_natural(evs[i], tables["br"],
                                            tables["inv"], tables["ninv"])
        on_coset.append(domain.coset_forward(coeffs, tables["coset"],
                                             tables["fwd"]))
    return _h_finish(*on_coset, tinv, tables, demont)


def _witness_u64(w_full: list) -> np.ndarray:
    """The witness as plain uint64[n, 4] rows (reduced mod r)."""
    return sn.ints_to_u64x4([v % R for v in w_full])


@torch.inference_mode()
def compute_h_device(r1cs, w_full, n: int, as_limbs: bool = False,
                     device=None, w64: np.ndarray | None = None,
                     timings: dict | None = None):
    """H(X) coefficients with the NTT work on the device. The U/V/W row
    evaluations run through the native CSR matvec (``native/witness.cpp``;
    ``w64`` is the witness as uint64[n, 4], built here if not passed).
    ``as_limbs=True`` returns plain limbs int64[n, 16] on the device (the H
    leg's MSM scalars); else ints. ``timings``, if a dict, receives the
    seconds of the row evaluations and their upload as ``h_rows``."""
    dev = resolve_device(device)
    m = len(r1cs.a_rows)
    if w64 is None:
        w64 = _witness_u64(w_full)
    with _phase(timings, "prove.h_rows", dev):
        evs = np.zeros((3, n, 4), dtype=np.uint64)
        for i, rows in enumerate((r1cs.a_rows, r1cs.b_rows, r1cs.c_rows)):
            evs[i, :m] = sn.eval_rows_native((id(r1cs), i), rows, w64)
        # plain u64x4 rows are the packed wire format; Montgomery on the
        # device
        ev_m = _unpack_mont_fr(evs.view("<u4").reshape(3, n, NLIMB // 2),
                               dev)
    # t(g w^i) = g^n - 1, constant on the coset.
    t_coset_inv = pow(pow(domain.COSET_G, n, R) - 1, -1, R)
    tinv_m = torch.as_tensor(FR.to_mont([t_coset_inv])[0], device=dev)
    pipeline = _h_pipeline_split if n >= _H_SPLIT_MIN_N else _h_pipeline
    h_m = pipeline(ev_m, tinv_m, domain.tables(n, dev), as_limbs)
    if as_limbs:
        return h_m
    return [int(v) for v in FR.from_mont(h_m)]


def _dispatch_legs(dpk: DeviceProvingKey, r1cs, w_full: list, timings=None):
    """Run the five MSMs and the H NTT feeding the H leg. Returns the
    device outputs (a, b1, b2, ht, k), each an (X, Y, Z) tuple."""
    with span("prove.dispatch"):
        pk, dev = dpk.pk, dpk.device
        n = pk.n_domain
        with _phase(timings, "prove.pack_witness", dev):
            w64 = _witness_u64(w_full)
        with _phase(timings, "prove.upload", dev):
            w_limbs = _scalar_limbs(w64, max(dpk._na, dpk._nb2), dev)
            if pk.committed:
                cset = set(pk.committed)
                priv = w64[[i for i in range(r1cs.num_public, len(w_full))
                            if i not in cset]]
            else:
                priv = w64[r1cs.num_public:]
            k_limbs = _scalar_limbs(priv, dpk._nk, dev)
        with _phase(timings, "msm.a", dev):
            a_out = dpk._msm_g1(dpk.a_query, dpk._na, w_limbs)
        with _phase(timings, "msm.b1", dev):
            b1_out = dpk._msm_g1(dpk.b1_query, dpk._na, w_limbs)
        with _phase(timings, "msm.b2", dev):
            b2_out = dpk._msm_g2(w_limbs)
        with _phase(timings, "prove.h_ntt", dev):
            h_limbs = compute_h_device(r1cs, w_full, n, as_limbs=True,
                                       device=dev, w64=w64, timings=timings)
            h_pad = torch.cat([h_limbs[: n - 1],
                               h_limbs.new_zeros((dpk._nh - (n - 1), NLIMB))])
        with _phase(timings, "msm.h", dev):
            ht_out = dpk._msm_g1(dpk.h_query, dpk._nh, h_pad)
        with _phase(timings, "msm.k", dev):
            k_out = dpk._msm_g1(dpk.k_query, dpk._nk, k_limbs)
        return (a_out, b1_out, b2_out, ht_out, k_out)


def _fetch(legs):
    return [tuple(t.cpu() for t in leg) for leg in legs]


@torch.inference_mode()
def prove(dpk: DeviceProvingKey, r1cs, w_full: list, seed: int = 7,
          timings: dict | None = None):
    """Groth16 proof with the four G1 MSMs, the G2 MSM and H(X) on the
    device. Returns (A, B2, C), or (A, B2, C, Commitment, Pok) for a
    committed circuit, equal to ``refimpl.groth16_ref.prove`` (JAX package)
    for the same seed. ``timings``, if a dict, receives each phase's
    seconds (the device is synchronized around every phase)."""
    rng = random.Random(seed)
    r_rand, s_rand = rng.randrange(R), rng.randrange(R)
    with span("prove.proof"):
        legs = _dispatch_legs(dpk, r1cs, w_full, timings)
        with _phase(timings, "prove.fetch", dpk.device):
            fetched = _fetch(legs)
        with _phase(timings, "prove.combine", dpk.device):
            return _finish_proof(dpk, fetched, r_rand, s_rand, w_full)


def _finish_proof(dpk: DeviceProvingKey, fetched, r_rand: int, s_rand: int,
                  w_full: list):
    """Host combine of the fetched MSM legs into the final proof."""
    pk = dpk.pk
    a_out, b1_out, b2_out, ht_out, k_out = fetched

    A = pr.g1_add(pk.alpha1, _g1_affine(a_out))
    A = pr.g1_add(A, pr.g1_mul(r_rand, pk.delta1) if r_rand else None)

    B1 = pr.g1_add(pk.beta1, _g1_affine(b1_out))
    B1 = pr.g1_add(B1, pr.g1_mul(s_rand, pk.delta1) if s_rand else None)

    B2 = pr.g2_add(pk.beta2, _g2_affine(b2_out))
    B2 = pr.g2_add(B2, pr.g2_mul(s_rand, pk.delta2) if s_rand else None)

    C = pr.g1_add(_g1_affine(k_out), _g1_affine(ht_out))
    C = pr.g1_add(C, pr.g1_mul(s_rand, A) if s_rand else None)
    C = pr.g1_add(C, pr.g1_mul(r_rand, B1) if r_rand else None)
    rs = r_rand * s_rand % R
    C = pr.g1_add(C, pr.g1_mul((R - rs) % R, pk.delta1) if rs else None)
    if pk.committed:
        from tpu_zkpool_torch.refimpl import pedersen
        cm, pok = pedersen.commit(
            list(pk.basis), list(pk.basis_exp_sigma),
            [w_full[i] for i in pk.committed])
        return (A, B2, C, cm, pok)
    return (A, B2, C)


@torch.inference_mode()
def prove_batch(dpk: DeviceProvingKey, r1cs, witnesses: list,
                seed: int = 7):
    """Prove several witnesses: every proof's legs are dispatched before any
    is fetched. Proof i uses the blinding of ``seed + i``, so it equals
    ``prove(dpk, r1cs, witnesses[i], seed + i)``."""
    rng_pairs = []
    for i in range(len(witnesses)):
        rng = random.Random(seed + i)
        rng_pairs.append((rng.randrange(R), rng.randrange(R)))
    with span("prove.batch"):
        legs = [_dispatch_legs(dpk, r1cs, w) for w in witnesses]
        out = []
        for f, (r, s), w in zip(legs, rng_pairs, witnesses):
            with span("prove.fetch"):
                fetched = _fetch(f)
            with span("prove.combine"):
                out.append(_finish_proof(dpk, fetched, r, s, w))
        return out
