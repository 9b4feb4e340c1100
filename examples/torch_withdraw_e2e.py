#!/usr/bin/env python3
"""End-to-end withdraw proof on the PyTorch/CUDA port: ACIR -> R1CS ->
Groth16 on the GPU -> wire format -> pool.

The port's counterpart of ``examples/withdraw_e2e.py``, the replacement for
the reference pipeline ``nargo execute && sunspot compile/setup/prove/
verify`` plus the on-chain withdraw (``noir_circuit/prove_linux.sh``,
``client/test-shielded-pool.ts``):

1. parse the withdraw circuit's ACIR artifact, solve its witness natively
   for the committed prover-params vector (``tests/vectors.py``) and
   convert it to a satisfied R1CS;
2. ``cached_setup``, the proving key's queries on the device, a cold and a
   warm proof (the MSMs through kernels K1-K6, H(X) on the device);
3. ``verify_batch`` (kernels P1 and P2): both proofs accepted, public
   input + 1 rejected;
4. the gnark wire layout through the pool's state machine: a withdrawal
   accepted, the double spend rejected.

    python3 examples/torch_withdraw_e2e.py [--artifact PATH] [--device cpu]

The device is ``cuda`` unless ``--device`` names another; without a GPU
the script raises. ``--artifact`` defaults to the reference checkout's
``noir_circuit/target/shielded_pool_verifier.json`` from its root;
``scripts/withdraw_acir.py OUT.json`` writes a withdraw artifact.
"""

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

from tpu_zkpool_torch import resolve_device  # noqa: E402
from tpu_zkpool_torch.groth16 import r1cs as r1cs_mod  # noqa: E402
from tpu_zkpool_torch.groth16 import solver_native  # noqa: E402
from tpu_zkpool_torch.groth16.acir import load_artifact  # noqa: E402
from tpu_zkpool_torch.groth16.cache import cached_setup  # noqa: E402
from tpu_zkpool_torch.groth16.gnark_fmt import (  # noqa: E402
    emit_proof, parse_proof, parse_public_witness)
from tpu_zkpool_torch.groth16.prove import (  # noqa: E402
    DeviceProvingKey, prove)
from tpu_zkpool_torch.groth16.verify import verify_batch  # noqa: E402
from tpu_zkpool_torch.protocol import flows  # noqa: E402
from tpu_zkpool_torch.protocol.state import (  # noqa: E402
    PROOF_LEN, Pool, PoolError)
from tpu_zkpool_torch.webui.app import DEFAULT_ARTIFACT  # noqa: E402

import vectors  # noqa: E402


def main(argv=None) -> dict:
    """Run the journey; returns each step's seconds and the circuit's
    size (raises on a failed check)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifact", default=DEFAULT_ARTIFACT)
    ap.add_argument("--device", default=None, help="default cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    clock = time.perf_counter
    out = {}

    print("=== 1. parse + solve + convert the withdraw circuit ===")
    t0 = clock()
    abi, prog = load_artifact(args.artifact)
    out["parse_s"] = clock() - t0
    t0 = clock()
    ar = r1cs_mod.convert(prog)
    out["convert_s"] = clock() - t0
    t0 = clock()
    w_acir = solver_native.solve(prog, vectors.withdraw_inputs())
    out["solve_s"] = clock() - t0
    t0 = clock()
    w = r1cs_mod.build_witness(ar, w_acir)
    out["witness_s"] = clock() - t0
    assert ar.r1cs.is_satisfied(w), "the R1CS witness is not satisfied"
    out["rows"] = len(ar.r1cs.a_rows)
    print(f"{out['rows']} constraints satisfied")

    print("=== 2. Groth16 setup / prove on", dev, "===")
    t0 = clock()
    pk, vk = cached_setup(ar.r1cs, verbose=True)
    out["setup_s"] = clock() - t0
    t0 = clock()
    dpk = DeviceProvingKey(pk, device=dev)
    out["upload_s"] = clock() - t0
    out["cold_phases"], out["warm_phases"] = {}, {}
    t0 = clock()
    proof = prove(dpk, ar.r1cs, w, timings=out["cold_phases"])
    out["prove_cold_s"] = clock() - t0
    t0 = clock()
    proof2 = prove(dpk, ar.r1cs, w, seed=11, timings=out["warm_phases"])
    out["prove_warm_s"] = clock() - t0
    print(f"setup {out['setup_s']:.1f} s, key upload {out['upload_s']:.1f} "
          f"s, prove cold {out['prove_cold_s']:.2f} s, warm "
          f"{out['prove_warm_s']:.2f} s")

    pub = w[1:ar.r1cs.num_public]
    t0 = clock()
    ok = verify_batch(vk, [proof, proof2, proof],
                      [pub, pub, [pub[0] + 1] + pub[1:]], device=dev)
    out["verify_s"] = clock() - t0
    assert ok.tolist() == [True, True, False], f"verify {ok.tolist()}"
    print("verify ok (+ negative)")

    print("=== 3. wire format + pool flow ===")
    wire = emit_proof(proof[0], proof[1], proof[2], [(1, 2)], (1, 2))
    assert len(wire) == PROOF_LEN

    def verifier(proof_bytes, witness_bytes):
        pf = parse_proof(proof_bytes)
        vals = parse_public_witness(witness_bytes)
        return bool(verify_batch(vk, [(pf.ar, pf.bs, pf.krs)], [vals],
                                 device=dev)[0])

    pool = Pool(withdraw_verifier=verifier, audit_verifier=lambda p, wt: True)
    pool.initialize()
    pool.vault_lamports += 2 * vectors.AMOUNT
    pool.state.add_root(vectors.ROOT)
    pool.submit_audit(b"\x01" * PROOF_LEN,
                      flows.audit_witness_blob(vectors.WA_COMMITMENT, 0))
    wit = flows.WithdrawWitness(
        root=vectors.ROOT, nullifier=vectors.NULLIFIER,
        recipient_field=vectors.RECIPIENT, amount=vectors.AMOUNT,
        wa_commitment=vectors.WA_COMMITMENT, secret_key=0, owner_x=0,
        owner_y=0, randomness=0, index=0, siblings=[0] * 16)
    t0 = clock()
    rec, amt = pool.withdraw(wire, wit.witness_blob())
    out["pool_withdraw_s"] = clock() - t0
    print(f"withdraw ok: {amt} lamports -> {rec.hex()[:16]}...")
    try:
        pool.withdraw(wire, wit.witness_blob())
        raise AssertionError("double spend accepted")
    except PoolError:
        print("double spend rejected")
    print("E2E OK")
    return out


if __name__ == "__main__":
    main()
