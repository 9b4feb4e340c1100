"""Batched Groth16 verification on the GPU.

The port of ``tpu_zkpool/groth16/verify_tpu.py``. It checks
e(A, B) = e(alpha, beta) e(L_pub, gamma) e(C, delta) for a batch of proofs
in one device computation over precomputed Miller lines
(``curve.lines``):

- the fixed VK legs (gamma, delta, and the commitment key's G and
  GSigmaNeg) walk the 6x+2 schedule once on the host per VK and become
  device line arrays;
- the per-proof B legs get the same walk per batch, with the host Fp2
  inversions batched across proofs;
- the constant e(alpha, beta) is a host pairing evaluated once per VK and
  compared with after the shared final exponentiation;
- the public-input accumulation L_pub runs through the native C++
  Pippenger (``native_bridge.g1_msm``).

The device part is the pairing kernels P1 (the three-leg Miller loop) and
P2 (the final exponentiation), ``curve.pairing_kernels``.

gnark's Pedersen commitment extension is handled as in
``refimpl.groth16_ref.verify``: the commitment folds into the gamma leg
with its hash-to-field as the derived final public input, and the proof of
knowledge e(Cm, GSigmaNeg) e(Pok, G) == 1 runs as a second two-leg batched
pairing. A batch is uniformly committed or not.

A B point that meets a zero denominator in the host walk (possible only
for a point that is not a valid G2 point of order r) is marked invalid,
and every other proof of the batch verifies exactly (``lines._batch_f2_inv``).
"""

from __future__ import annotations

import time

import numpy as np

from tpu_zkpool_torch import native_bridge, resolve_device
from tpu_zkpool_torch.curve import lines
from tpu_zkpool_torch.curve import pairing as pj
from tpu_zkpool_torch.fields.bn254 import FR_MOD
from tpu_zkpool_torch.refimpl import pairing_ref as pr
from tpu_zkpool_torch.refimpl import pedersen


def _g1neg(p):
    return (p[0], (-p[1]) % pr.P)


# Per-VK precompute: fixed-leg line arrays, the e(alpha, beta) target and
# the commitment key's PoK-leg lines, on one device. Keyed by (id(vk),
# device) with the vk object held in the value so the id stays valid.
_VK_CACHE: dict = {}


def _vk_fixed(vk, device):
    key = (id(vk), device)
    hit = _VK_CACHE.get(key)
    if hit is not None and hit[0] is vk:
        return hit[1]
    gamma_l = lines.precompute_g2_lines(vk.gamma2, device)
    delta_l = lines.precompute_g2_lines(vk.delta2, device)
    target = pj.f12_to_limbs(pr.pairing(vk.alpha1, vk.beta2), device)
    pok_legs = None
    ck = getattr(vk, "commitment_key", None)
    if ck is not None:
        g, gsn = ck
        pok_legs = (lines.precompute_g2_lines(gsn, device),
                    lines.precompute_g2_lines(g, device))
    entry = (gamma_l, delta_l, target, pok_legs)
    _VK_CACHE[key] = (vk, entry)
    return entry


def _l_pub(vk, proof, pub):
    """Public-input accumulator of one proof via the native Pippenger."""
    pub = list(pub)
    cm = proof[3] if len(proof) == 5 else None
    if cm is not None:
        pub.append(pedersen.commitment_to_field(cm))
    ks, pts = [1], [vk.gamma_abc[0]]
    for x, pnt in zip(pub, vk.gamma_abc[1:]):
        if x % FR_MOD:
            ks.append(x % FR_MOD)
            pts.append(pnt)
    if cm is not None:
        ks.append(1)
        pts.append(cm)
    if len(ks) == 1:
        return vk.gamma_abc[0]
    return native_bridge.g1_msm(ks, pts)


def check_public_counts(vk, proofs: list, publics: list):
    """Raise ``ValueError`` unless there is one public list a proof and
    each holds ``len(vk.gamma_abc) - 1`` inputs, a committed proof's
    derived commitment input counted (the JAX copy pairs them by ``zip``,
    so a short list verifies as if padded with zeros and a long one is
    cut)."""
    if len(publics) != len(proofs):
        raise ValueError(f"{len(proofs)} proofs and {len(publics)} public "
                         f"lists")
    want = len(vk.gamma_abc) - 1
    for i, (proof, pub) in enumerate(zip(proofs, publics)):
        n = len(pub) + (len(proof) == 5 and proof[3] is not None)
        if n != want:
            raise ValueError(f"proof {i}: {n} public inputs, the VK takes "
                             f"{want}")


def verify_batch(vk, proofs: list, publics: list, device=None,
                 timings: dict | None = None) -> np.ndarray:
    """vk: ``refimpl.groth16_ref.VerifyingKey``; proofs: [(A, B2, C)] or
    [(A, B2, C, Commitment, Pok)] affine tuples; publics: [[ints]] without
    the derived commitment-hash input, each as many as the VK takes
    (``check_public_counts`` raises ``ValueError`` otherwise). Returns
    bool[n], each proof's validity. ``timings``, if a dict, receives the
    seconds of the host parts (``vk``, ``l_pub``, ``b_lines``, ``b_pack``,
    ``g1``) and of the device part (``device``: the two kernels and the
    fetch of the result)."""
    dev = resolve_device(device)
    if not proofs:
        return np.zeros(0, dtype=bool)
    clock = time.perf_counter
    t = {}
    has_cm = any(len(p) == 5 for p in proofs)
    # the batched Miller loop has no point-at-infinity lanes: a batch must
    # be uniformly committed or uniformly not
    assert not has_cm or all(len(p) == 5 and p[3] is not None
                             and p[4] is not None
                             for p in proofs), "mixed commitment batch"
    check_public_counts(vk, proofs, publics)
    t0 = clock()
    gamma_l, delta_l, target, pok_legs = _vk_fixed(vk, dev)
    t["vk"] = clock() - t0
    assert not has_cm or pok_legs is not None, "VK lacks a commitment key"

    t0 = clock()
    Ls = [_l_pub(vk, proof, pub) for proof, pub in zip(proofs, publics)]
    t["l_pub"] = clock() - t0
    t0 = clock()
    bad = set()
    sched = lines.g2_line_schedules_batch([p[1] for p in proofs], bad)
    t["b_lines"] = clock() - t0
    t0 = clock()
    b_lines = lines._pack(sched, dev)
    t["b_pack"] = clock() - t0
    t0 = clock()
    a_pts = pj.g1_to_limbs([p[0] for p in proofs], dev)
    l_neg = pj.g1_to_limbs([_g1neg(L) for L in Ls], dev)
    c_neg = pj.g1_to_limbs([_g1neg(p[2]) for p in proofs], dev)
    if has_cm:
        cms = pj.g1_to_limbs([p[3] for p in proofs], dev)
        poks = pj.g1_to_limbs([p[4] for p in proofs], dev)
    t["g1"] = clock() - t0

    t0 = clock()
    # e(A,B) * e(-L, gamma) * e(-C, delta) == e(alpha, beta)
    ok = pj.pairing_lines_equal((a_pts, l_neg, c_neg),
                                (b_lines, gamma_l, delta_l), target)
    if has_cm:
        # per-proof PoK: e(Cm, GSigmaNeg) * e(Pok, G) == 1
        ok = ok & pj.pairing_lines_equal((cms, poks), pok_legs, None)
    ok = ok.cpu().numpy()
    t["device"] = clock() - t0
    for i in bad:
        ok[i] = False
    if timings is not None:
        for k, v in t.items():
            timings[k] = timings.get(k, 0.0) + v
    return ok
