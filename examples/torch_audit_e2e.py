#!/usr/bin/env python3
"""End-to-end audit proof on the PyTorch/CUDA port: RLWE encrypt -> audit
R1CS -> Groth16 on the GPU.

The port's counterpart of ``examples/audit_e2e.py``, the same flow over
``tpu_zkpool_torch``; the proofs run on the device (``cuda`` unless
``--device`` names another; without a GPU the script raises) and are
verified through ``verify_batch``. The auditor public key is read from
``--rlwe-dir`` (the reference checkout's ``demo-frontend/public/rlwe``
from its root by default; ``tpu_zkpool_torch.webui.write_rlwe_dir``
writes one).

The full replacement for ``scripts/generate_audit.py``'s pipeline (circuit
generation + nargo + sunspot): encrypts the identity under the committed
auditor public key, assembles quotient witnesses, builds the audit circuit
directly as R1CS, and proves/verifies with our Groth16.
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

from tpu_zkpool_torch import resolve_device  # noqa: E402
from tpu_zkpool_torch.groth16.cache import cached_setup  # noqa: E402
from tpu_zkpool_torch.groth16.prove import (  # noqa: E402
    DeviceProvingKey, prove)
from tpu_zkpool_torch.groth16.verify import verify_batch  # noqa: E402
from tpu_zkpool_torch.hash.poseidon_params import (  # noqa: E402
    poseidon_hash_ref)
from tpu_zkpool_torch.protocol.audit_circuit import (  # noqa: E402
    build_audit_circuit, ct_commitment_of)
from tpu_zkpool_torch.refimpl import rlwe_ref  # noqa: E402
from tpu_zkpool_torch.webui.app import DEFAULT_RLWE_DIR  # noqa: E402

import vectors  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rlwe-dir", default=DEFAULT_RLWE_DIR)
    ap.add_argument("--device", default=None, help="default cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with open(os.path.join(args.rlwe_dir, "rlwe_pk.json")) as f:
        pk = json.load(f)
    a_pk = [int(v, 16) for v in pk["a"]]
    b_pk = [int(v, 16) for v in pk["b"]]

    print("=== 1. build audit circuit (R1CS) ===")
    t0 = time.time()
    circ = build_audit_circuit(a_pk, b_pk)
    r1cs = circ.builder.r1cs()
    print(f"{len(r1cs.a_rows)} constraints in {time.time()-t0:.1f}s")

    print("=== 2. encrypt + witness ===")
    enc = rlwe_ref.encrypt(a_pk, b_pk, vectors.OWNER_X, vectors.OWNER_Y, seed=999)
    wa = poseidon_hash_ref([vectors.OWNER_X, vectors.OWNER_Y])
    ct = ct_commitment_of(enc)
    w = circ.builder.witness(
        circ.assignment(vectors.OWNER_X, vectors.OWNER_Y, enc, wa, ct,
                        vectors.SECRET_KEY))
    assert r1cs.is_satisfied(w)
    print(f"wa={hex(wa)[:18]} ct={hex(ct)[:18]}; witness satisfied")

    print("=== 3. Groth16 on", dev, "===")
    t0 = time.time()
    pkg, vkg = cached_setup(r1cs, verbose=True)
    print(f"setup: {time.time()-t0:.0f}s")
    # the four G1 MSMs, the G2 MSM (kernels K1-K6) and H(X) on the device
    t0 = time.time()
    dpk = DeviceProvingKey(pkg, device=dev)
    print(f"device pk upload: {time.time()-t0:.0f}s")
    t0 = time.time()
    proof = prove(dpk, r1cs, w)
    print(f"prove cold: {time.time()-t0:.1f}s")
    t0 = time.time()
    proof2 = prove(dpk, r1cs, w, seed=11)
    print(f"prove warm: {time.time()-t0:.1f}s")
    ok = verify_batch(vkg, [proof, proof2, proof],
                      [[wa, ct], [wa, ct], [wa, ct + 1]], device=dev)
    assert ok.tolist() == [True, True, False], f"verify {ok.tolist()}"
    print("verify ok (+ negative). E2E OK")


if __name__ == "__main__":
    main()
