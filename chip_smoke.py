#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpu_zkpool_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; exits non-zero on a failure
    python3 chip_smoke.py --profile  # also trace warm proofs, a build, an MSM
    python3 chip_smoke.py --out DIR  # details directory (default chip_smoke_out/)

Phases, one line each:
  0 card     nvidia-smi name and power limit, torch and CUDA versions;
  1 build    nvcc builds the grid-MSM kernels, the Poseidon kernel, the
             affine-tree kernel, the NTT exchange kernel, the pairing
             kernels, the Poseidon2 kernel, the H(X) kernels and the
             product microbenchmark, g++ the two native host libraries,
             all ten started together; meanwhile phase 15's circuit is
             built and set up on the host (it needs no kernel) and, once
             P2 is built, phase 13's naive pairing runs in a worker
             process of this script (--naive-pairing-worker);
  2 kernels  the product microbenchmark first (one thread, a dependent
             chain of 4,096 Fp and Fp2 products: out of line, inlined C,
             inlined PTX carry chains, three chains interleaved, PTX out
             of line, three chains on three lanes of a warp, and over Fp
             one chain with each product split over 4 and over 8 lanes;
             us a product, every form on form a's limbs), then the inverse
             microbenchmark (one thread, 16 inversions x <- 1/x + y as
             Fermat with fp_mul, Fermat with a 4-bit window and dedicated
             squares, and safegcd; 4,096 squares by fp_mul and by fp_sqr;
             us a step, each form on the same limbs); then each kernel
             K1-K6, for Fp (G1) and Fp2 (G2), K7 and K8, against its plain
             torch twin on the card (equal limb for limb): every mode on
             small inputs with the special cases (K1 over several windows;
             K2 at k = 1, 5, 32, 64, mixed, mixed-incomplete and Jacobian,
             and K3 at L = 1, 5, 32, 128, with identity, doubling and
             cancelling lanes; K4 plain and in seven gathered modes:
             sentinel rows on either side, the zero mask, neg_b on Y = 0
             rows, equal and opposite operands; K5 at s = 0, 1, 7 on
             planted doublings, cancellations and identities; K6 on
             planted identity, doubling, cancelling and equal windows; K7 at every width t = 2 .. 17 in each
             layout built for it, and for t = 2, 3, 5, 17 at B = 1, 2,
             31, 64, 4,096 and 32,768 in the wrapper's layout, with 0, 1
             and r - 1 planted; K8 complete and incomplete at M = 1 once a
             planted kind, 40, 1,023, 1,025, 4,096 and the prover's level
             0, with doublings, cancelling pairs, each infinity flag and
             zero denominators planted; a twin that works row by row runs
             once over the cases that share its other inputs), then K1-K7
             at the withdraw proof's and
             the Merkle tree's shapes (K1 one launch over 20 windows, K2 and
             K3 at both of their prover shapes, K4 plain at 81,920 rows and
             at a real leg's excl, E and B calls, also in a CUDA graph with
             the card's clocks, power and temperature sampled beside it),
             timed beside the twin, the bound and (K2, K5, K6, K7) the
             chain floor; K7 alone at every width; then P4 against
             pass_plain at every (h_first, count) of n = 2 .. 2^10, both
             directions, P = 1 and 3, each fused step on and off (the
             quotient and the folded demont scalar too), 0, 1 and r - 1
             planted, the plan's passes and single stages at 2^14, whole
             two-pass transforms at 2^21 against forward_plain and
             inverse_plain, P5 against FieldCtx in each mode, then both
             timed beside the plain versions and the bound (the prover's
             five transforms at 2^14, P = 3; the forward and the coset
             inverse and each forward pass at 2^21; P5's quotient at 2^14
             and 2^21 and its R^2 step);
  3 msm      a G1 MSM of 2^18 points (two sub-slices folded through K4) and a
             G2 MSM of 2^14 points against the native Pippenger oracle;
             the MSM benchmark's inputs at 2^17 (benchvec: bases and
             scalars from random.Random(7)) against the committed point of
             bench_expected.json;
  4 prove    a seeded synthetic R1CS of the withdraw proof's shape (8,899
             rows, domain 2^14): setup, one cold and three warm proofs, each
             verified and a tampered input rejected, prove_batch (B = 4)
             against prove(seed + i), per-phase times; the H(X) pipeline
             through P4 and P5 equal to its plain twin on the card, under
             torch.cuda.set_sync_debug_mode("error") (no host sync), its
             device kernels by torch.profiler (P4 and P5 only), P4 at
             three transforms of pass_plan's passes a proof and P5 once,
             and h_ntt, h_rows and upload over four more proofs;
  6 merkle   the depth-16 tree at full capacity: build_levels over 2^16
             seeded leaves on the card (16 K7 launches), every level against
             the plain twin and 64 sampled nodes per level against the host
             oracle; a MerkleTree on the card of 256 host inserts, its
             device-built root against its frontier root, 8 proofs verified
             and a tampered one rejected; warm ms of the 2^16 build; K7
             at each level's width as the wrapper runs it and in both
             layouts, beside its chain floor;
  7 chain    bench.py's Poseidon throughput shape: a hash2 chain, batch 2^15
             x 4, warm best of 3, in hashes/s, sampled outputs against the
             host oracle;
  8 tree     ``tree=True``: K8 at the prover's level 0 (20 x 8,192 pairs)
             against its twin, timed beside it, its bound and its chain
             floor, then alone at each of the leg's 14 level widths beside
             their bounds and floors; phase 3's 2^18 G1 MSM and a
             2^14 MSM with all-equal scalars against the native oracle;
             phase 4's key with tree=True: one cold and three warm proofs,
             verified, a tampered input rejected, the seed-7 proof equal to
             phase 4's, per-phase times, K8 launches per proof;
  9 mesh     the sharded paths on D virtual shards of one card
             (``Mesh.virtual``; the log says how many cards torch sees): K9,
             one launch a stage over every slot, against its twin in every
             mode (one shard and whole stages at D = 2, 4, 8, forward and
             inverse, rdma reading the partners' shards and ppermute their
             copies, at S = 256, an odd S and B = 1, random tw and tw = R
             mod q, the edge values 0, 1, q - 1), then the whole stage at
             the audit ring's shape (D = 8, B = 4,096) beside its twin and
             bound, by CUDA events, in a CUDA graph and, through the mesh,
             by the host clock; the sharded negacyclic NTT (n = 1,024,
             4,096 polynomials, D = 2, 4, 8, both exchanges), each call a
             replay of the transform's CUDA graph, every replay against the
             single-device NTT, its inverse and four rows against the
             schoolbook; ms a product by replay (host clock and events) and
             eager, K9 launches a product;
             phase 3's 2^18 G1 MSM over dp = 2, 4, 8 and a (host 2, chip 4)
             mesh, four 2^14-point legs on a (leg 4, pt 2) mesh, against
             the native oracle; 2^16 leaves in 8 dp shards, subtrees through
             K7 and one root combine, against build_levels;
 10 verify   the batched Groth16 verify: P1 (k_miller_lines) and P2
             (k_final_exp) against their plain versions limb for limb (P1
             with 3 legs, two fixed at batch stride 0, at B = 256, 1, 3, 4,
             33 and with 2 batched legs at B = 1, 3, 4, 33, where B = 1, 3
             and 33 leave the last block of two warps partial; P2 on P1's
             outputs and on random Fp12 values with 1 and 0 planted), both
             timed by CUDA events at B = 256 beside the plain version, the
             bound and the chain floor; then 32 distinct proofs of phase 4's
             key tiled to 256, verified cold and warm (proofs/s, the host/device
             split), a batch with four planted faults (exactly those
             rejected, its 32 distinct proofs against refimpl's verify) and
             a committed batch with one tampered proof of knowledge;
 11 audit    the audit path: P3 (k_poseidon2) against its plain version
             limb for limb, the permutation at B = 1, 2, 33, 256, 4,096 and
             the ct_commitment sponge at each B and n = 0, 1, 2, 3, 4, 157,
             with 0, 1 and r - 1 planted, and bb's permutation(0, 1, 2,
             3); the plain sponge at B = 4,096, n = 157 timed on the card
             in that check (its FieldCtx calls, a permutation's device
             launches) beside P3 on the same inputs, and P3 alone at B =
             1, 256, 4,096 beside its bound and chain
             floor (192 product levels a permutation at phase 2's form g
             time); keygen from rlwe_ref.keygen(42)'s randomness, Shamir
             shares and every pair's reconstruction on the card; 256
             identities encrypted with their quotient witnesses (four held
             to rlwe_ref.encrypt, all to k q + rem = full in int64 numpy),
             decrypted, and committed through P3 against
             ct_commitment_ref; the committed 24,070-row audit circuit
             built, set up, solved, proved on the card (AUDIT_PROOFS
             proofs, cut for time to one; per-phase times) and verified
             through P1 and P2, ct + 1 and a tampered proof of knowledge
             rejected; the
             auditor's decrypt from shares 1 and 2, its K7 hash equal to
             the proof's wa_commitment;
 12 pool     the pool as its users touch it. (a) The client curves (A8,
             FieldCtx torch ops, no kernel): CurveOps.add and double on
             the embedded curve and G1 at B = 256 with identity, doubling
             and cancelling lanes planted, scalar_mul at B = 256 (128 bits
             embedded, 64 bits G1), the c = 8 keygen table at B = 1, 256
             and 1,024 (k = 0, 1, order - 1, 2^128 - 1 and the committed
             identity vector planted), all held to curve_ref and
             pairing_ref, with warm ms and CUDA launches a call (the
             profiler; the launch line of a keygen beside a whole profile
             of 4 windows, and one window's kernels by name at B = 1 and
             256). (b) The demo app (webui.DemoApp) on the card behind
             its HTTP server on 127.0.0.1: 16 deposits, 8 withdrawals to
             distinct
             recipients, a double spend (400, the typed nullifier error),
             8 decrypts, the tables (cut for time, as the pre-filled
             store); stored commitments against
             poseidon_hash_ref, every sibling path against its root, the
             root against build_levels on the card, a restart on the same
             store; s a request. Then a new app on a store pre-filled with
             1,024 deposits: its restart, a deposit, its withdrawal and a
             decrypt, the same oracles; K7 launched 16 times a deposit
             during each app's requests, exactly. (c) Phase 4's withdraw-shape proofs and
             phase 11's audit proofs through emit_proof, proof_hex bundles,
             save / load and parse_proof, equal to the originals, verified
             by verify_batch (P1, P2); one flipped byte in each of two
             proofs rejects exactly those two;
 13 withdraw the withdraw proof from an ACIR program. (a) The depth-16
             withdraw artifact written by scripts/withdraw_acir.py under
             --out, parsed and converted (rows, domain); the committed
             vector (tests/vectors.py) solved by the interpreter and the
             native CompiledSolver (s a solve each), equal, with the
             committed root, nullifier and wa_commitment; a forged owner
             point unsatisfiable. (b) examples/torch_withdraw_e2e.py on it:
             parse, convert, native solve, a satisfied R1CS, cached_setup
             (cold, then warm), the proving key on the card, a cold and a
             warm proof with their phases, verify_batch (public + 1
             rejected), the wire format, a pool withdrawal, a double spend
             rejected. (c) DemoApp(prover="groth16") on the card behind
             make_server: 8 deposits, 4 withdrawals to distinct recipients
             with real proofs (solved natively, proved through K1-K6,
             verified by the pool through P1 and P2; s of each and its
             split), one proof re-verified on the host, four wrong
             proofs of one deposit refused (400): one flipped byte of A's
             y and B replaced by a twist point outside G2's subgroup (both
             fail to parse, no P1 or P2 launch), a real proof of another
             recipient and A negated (both well formed, rejected by P1
             and P2, whose launches rise for each), then that deposit
             withdrawn for
             real, a double spend (400, the typed nullifier error). The
             app's lock keeps two withdrawals of one note apart
             (tests/test_torch_webui.py sends them at once). (d) The naive
             pairing, pairing_product_is_one at B = 4 on planted true and
             false pairs, against pairing_ref (run during phase 1 in a
             worker process, logged here);
 14 pod      the pod path across processes: two worker processes of this
             script (--pod-worker RANK PORT DIR) on the one card, joined
             by multihost.initialize over Gloo (NCCL takes one card a
             rank), each with a (host 2, chip 4) pod_mesh of virtual
             slots on cuda:0, the host axis the process boundary; inputs
             from the parent as .npy under --out DIR/pod/ (deleted
             after). Each runs phase 3's 2^18 G1 MSM cold and warm
             (msm_grid_sharded_2d: one partial a process crosses, staged
             through host memory for Gloo), equal to phase 3's oracle
             point and phase 9's one-process (host 2, chip 4) point,
             times the cross-process gather alone, and the 2^16-leaf
             root over the eight slots of both processes, equal to phase
             6's; init_process_group s, ms and K1-K7 launches a rank. Then
             the sharded NTT across the two processes at phase 9's shape
             (n = 1,024, 4,096 polynomials a side) on a span_mesh of D = 2
             (one slot a process) and D = 8 (four a process), under both
             exchanges (ppermute: the shards through host memory over
             Gloo; rdma: K9 reading the partner's shard through a CUDA IPC
             mapping), eagerly: each product cold and warm equal to the
             single-device product, the forward and its inverse, K9's
             launches a product (3 log2 D a process), one crossing stage
             with its exchange's share, and under rdma that stage held
             to K9's twin on the partner's shard copied through host
             memory; the warm product beside phase 9's at the same D. A
             worker that fails, outlives its timeout or prints no
             sentinel fails the phase;
  15 variant the var-PK audit circuit var_pk_e_witness (1,185,473 rows,
             1,187,520 wires, domain 2^21) at full width through
             scripts/torch_benchmark_variants.py's run_variant: built
             and set up by setup (not cached) during phase 1, solved and
             checked, its query
             points on the card (c = 13, 1,024 lanes, complete), one cold
             and one warm proof (the split H(X) pipeline, 10- and 16-slice
             MSMs folded through K4), both accepted by verify_batch and
             rejected with a changed public input; each step's seconds,
             each proof's phases, the peak device memory, the host RSS,
             K1-K6, P1, P2, P4 and P5 launches over the phase; then the
             2^21 split H(X) pipeline once against its plain twin;
  5 launches every kernel's launch count on its main path, K1-K6, P4
             and P5 during phase 4 (and per proof), K7 during phase 6, K8
             during phase 8's proofs, K9 during phase 9's rdma products,
             P1 and P2 during phase 10's verify batches, K1-K7, P1, P2
             and P3 from phase 11's encryptions to its end, K7 during
             phase 12's HTTP requests, P1 and P2 during its wire checks,
             K1-K7, P1 and P2 during phase 13's HTTP requests, and
             K1-K6, P1, P2, P4 and P5 during phase 15 (must be > 0); it
             runs last.
``--profile`` traces one warm proof of each path, one warm 2^16 build and
one warm 2^18 tree MSM (K8's device ms against the rest).
Then the "kernels" JSON line, the card line, and the last line
{"ok": true, "device": {...}}. Needs a CUDA device and the repository's
``tpu_zkpool_torch``: without either it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import importlib.util
import json
import os
import random
import socket
import struct
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpu_zkpool_torch import benchvec, cuda_build, native_bridge
from tpu_zkpool_torch.curve import fixed_base, weierstrass
from tpu_zkpool_torch.curve import lines as plines
from tpu_zkpool_torch.curve import pairing, tower
from tpu_zkpool_torch.curve import pairing_kernels as pkern
from tpu_zkpool_torch.curve import pairing_program
from tpu_zkpool_torch.fields import rlweq
from tpu_zkpool_torch.fields.bn254 import FP_MOD, FR_MOD
from tpu_zkpool_torch.fields.fctx import FP, FR
from tpu_zkpool_torch.fields.limbs import int_to_limbs, ints_to_limbs
from tpu_zkpool_torch.groth16 import acir, domain, gnark_fmt
from tpu_zkpool_torch.groth16 import ntt_kernels as nkern
from tpu_zkpool_torch.groth16 import prove as tp
from tpu_zkpool_torch.groth16 import r1cs as acir_r1cs
from tpu_zkpool_torch.groth16 import solver as acir_solver
from tpu_zkpool_torch.groth16 import solver_native
from tpu_zkpool_torch.groth16.cache import cached_setup
from tpu_zkpool_torch.groth16 import verify as tverify
from tpu_zkpool_torch.hash import kernels as hkern
from tpu_zkpool_torch.hash import poseidon, poseidon2
from tpu_zkpool_torch.hash import poseidon2_kernels as p2k
from tpu_zkpool_torch.hash.poseidon_params import N_ROUNDS_F, N_ROUNDS_P
from tpu_zkpool_torch.hash.poseidon_params import poseidon_hash_ref
from tpu_zkpool_torch.merkle import TREE_DEPTH, MerkleTree, build_levels
from tpu_zkpool_torch.msm import affine_tree, grid, kernels
from tpu_zkpool_torch.msm import tree_kernels as tkern
from tpu_zkpool_torch.parallel import (Mesh, initialize, ntt_rdma,
                                       ntt_sharded, pod_mesh, span_mesh)
from tpu_zkpool_torch.parallel.merkle_sharded import root_sharded
from tpu_zkpool_torch.parallel.msm_sharded import (msm_grid_sharded,
                                                   msm_grid_sharded_2d)
from tpu_zkpool_torch.parallel.prove_stages import msm_legs_sharded
from tpu_zkpool_torch.refimpl import pairing_ref as pr
from tpu_zkpool_torch.protocol import audit_circuit, flows, proof_hex
from tpu_zkpool_torch.protocol import errors as perrors
from tpu_zkpool_torch.protocol import storage as pstorage
from tpu_zkpool_torch.refimpl import curve_ref, pedersen, rlwe_ref
from tpu_zkpool_torch.refimpl.groth16_ref import R1CS, setup, verify
from tpu_zkpool_torch.rlwe import encrypt as renc
from tpu_zkpool_torch.rlwe import ntt as rntt
from tpu_zkpool_torch.rlwe import quotient
from tpu_zkpool_torch.shamir import reconstruct_batch, share_batch
from tpu_zkpool_torch.utils.profiling import kernel_launches, launch_line
from tpu_zkpool_torch.webui import DemoApp, make_server, write_rlwe_dir

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM: 3.35 TB/s of HBM3; 32-bit integer multiply-adds at 64 per SM per
# clock (132 SMs).
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64
# 32-bit multiply-adds of one Fp Montgomery product (CIOS, 8 x 32-bit
# words): 64 product and 64 reduction word products, each a lo and a hi
# multiply-add, and 8 quotient words m = t0 * n0', one low product each.
MADDS_PER_FP_MUL = 2 * 64 + 2 * 64 + 8
# Field multiplications M and squarings S per point formula (grid.py):
# mixed add 8M + 3S, general add 12M + 4S, doubling 2M + 5S. The rare
# doubling branch of a complete add is not counted (this run's data takes
# it on a handful of lanes).
FORMULAS = {"pmadd": (8, 3), "padd": (12, 4), "pdouble": (2, 5)}
# Fp products per field M and S: 1 and 1 over Fp; over Fp2 a Karatsuba
# product takes 3 and a square 2 ((a + b)(a - b) and 2ab).
FP_PRODUCTS = {1: (1, 1), 2: (3, 2)}


def _fp_products(formula, ncomp):
    (m, s), (pm, ps) = FORMULAS[formula], FP_PRODUCTS[ncomp]
    return m * pm + s * ps


# kernel name -> (Pallas kernel it replaces, file:line of its pallas_call)
REPLACES = {
    "prefix_rows": "tpu_zkpool/msm/grid.py:439",
    "prefix": "tpu_zkpool/msm/grid.py:466",
    "wsum": "tpu_zkpool/msm/grid.py:524",
    "addn": "tpu_zkpool/msm/grid.py:554",
    "scale_add": "tpu_zkpool/msm/grid.py:579",
    "horner": "tpu_zkpool/msm/grid.py:615",
    "poseidon": "tpu_zkpool/hash/poseidon_pallas.py:206",
    "tree_level": "tpu_zkpool/msm/affine_tree.py:346",
    "exchange_butterfly": "tpu_zkpool/parallel/ntt_rdma.py:161",
    # the port kernels with no Pallas counterpart: the JAX package compiles
    # these two functions into one XLA program (_ppl_jit)
    "miller_lines": "tpu_zkpool/curve/pairing_jax.py:412 miller_loop_lines "
                    "(XLA, not a pallas_call)",
    "final_exp": "tpu_zkpool/curve/pairing_jax.py:305 final_exponentiation "
                 "(XLA, not a pallas_call)",
    # the audit path's Poseidon2 sponge, an XLA scan in the JAX package
    "poseidon2": "tpu_zkpool/hash/poseidon2.py:181 ct_commitment "
                 "(XLA, not a pallas_call)",
    # the prover's H(X), one XLA program in the JAX package: its NTT stages
    # (P4) and its element-wise steps (P5)
    "fr_pass": "tpu_zkpool/groth16/domain.py:73 forward / :91 inverse "
               "(XLA)",
    "fr_pointwise": "tpu_zkpool/groth16/prove_tpu.py:239 _h_pipeline "
                    "(XLA, not a pallas_call)",
}
SOURCES = dict.fromkeys(REPLACES, "tpu_zkpool_torch/csrc/msm_grid.cu")
SOURCES["poseidon"] = "tpu_zkpool_torch/csrc/poseidon.cu"
SOURCES["tree_level"] = "tpu_zkpool_torch/csrc/affine_tree.cu"
SOURCES["exchange_butterfly"] = "tpu_zkpool_torch/csrc/ntt_rdma.cu"
SOURCES["miller_lines"] = SOURCES["final_exp"] = \
    "tpu_zkpool_torch/csrc/pairing.cu"
SOURCES["poseidon2"] = "tpu_zkpool_torch/csrc/poseidon2.cu"
SOURCES["fr_pass"] = SOURCES["fr_pointwise"] = \
    "tpu_zkpool_torch/csrc/fr_ntt.cu"


_WALL = {}             # phase: s from the first line to its latest line


def log(phase, msg):
    _WALL.setdefault("start", time.perf_counter())
    _WALL[phase] = round(time.perf_counter() - _WALL["start"], 1)
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query):
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


# --------------------------------------------------------------- inputs

def _points(ncomp, n, seed):
    rng = random.Random(seed)
    ks = [rng.randrange(1, 1 << 250) for _ in range(n)]
    return (native_bridge.g1_gen_mul_batch if ncomp == 1
            else native_bridge.g2_gen_mul_batch)(ks)


def _neg(ncomp, p):
    return (p[0], (-p[1]) % FP_MOD) if ncomp == 1 else pr.g2_neg(p)


def _rows(ncomp, pts, rng, affine=False):
    """Points (None = identity) -> Jacobian rows int64[n, 3, ncomp, 16]
    with random Z (Z = 1 if ``affine``)."""
    out = []
    for p in pts:
        if p is None:
            out.append([[0] * ncomp] * 3)
        elif ncomp == 1:
            z = 1 if affine else rng.randrange(1, FP_MOD)
            out.append([[p[0] * z * z % FP_MOD], [p[1] * z ** 3 % FP_MOD],
                        [z]])
        else:
            z = (1, 0) if affine else (rng.randrange(1, FP_MOD),
                                       rng.randrange(FP_MOD))
            z2 = pr.f2_mul(z, z)
            out.append([list(pr.f2_mul(p[0], z2)),
                        list(pr.f2_mul(p[1], pr.f2_mul(z2, z))), list(z)])
    return torch.as_tensor(FP.to_mont(out))


def _special(ncomp, pts):
    """In every block of 16 points plant P = Q (rows i, i+1), P = -Q (i+2,
    i+3) and identities (i+4, and i+5 in every fourth block)."""
    pts = list(pts)
    for i in range(0, len(pts) - 1, 16):
        pts[i + 1] = pts[i]                          # P = Q
        if i + 3 < len(pts):
            pts[i + 3] = _neg(ncomp, pts[i + 2])     # P = -Q
        if i + 5 < len(pts):
            pts[i + 4] = None                        # identities
            if i % 64 == 0:
                pts[i + 5] = None
    return pts


WSUM_LS = (1, 5, 32, 128)      # K3's planted step counts (5 is ragged)


def prefix_payload(rng, W, k, lanes, signs0):
    """K1's payload (W, k, lanes), index | neg << 31: window 0 reads row j *
    lanes + l at step j of lane l with the signs ``signs0``; every other
    window a seeded permutation of the rows with random signs, step 1
    repeating step 0's row in every fourth lane with its sign (P = Q) and
    in the next lane with the other sign (P = -Q)."""
    n = k * lanes
    idx = [list(range(n))]
    sg = [signs0]
    for _ in range(1, W):
        perm = list(range(n))
        rng.shuffle(perm)
        s = [rng.randrange(2) for _ in range(n)]
        if k > 1:
            for l in range(0, lanes - 1, 4):
                m = lanes + l
                perm[m], s[m] = perm[l], s[l]
                perm[m + 1], s[m + 1] = perm[l + 1], 1 - s[l + 1]
        idx.append(perm)
        sg.append(s)
    return torch.tensor([[i | (b << 31) for i, b in zip(p, s)]
                         for p, s in zip(idx, sg)],
                        dtype=torch.int64).reshape(W, k, lanes)


def wsum_steps(ncomp, L, lanes, rng, seed):
    """K3 steps (L, lanes, 3, ncomp, 16) with random Z, a pattern per lane
    (lane % 8): identities planted in random points, all identities, one
    point repeated (equal partial sums: doublings), pairs B_(2i+1) =
    -B_(2i) (sums cancel), one point at the top step only, one at step 0
    only, every other step the identity, all random."""
    base = _points(ncomp, L * lanes, seed)
    lane = [[base[l * lanes + m] for l in range(L)] for m in range(lanes)]
    for m, g in enumerate(lane):
        kind = m % 8
        if kind == 0:
            lane[m] = _special(ncomp, g)
        elif kind == 1:
            lane[m] = [None] * L
        elif kind == 2:
            lane[m] = [g[0]] * L
        elif kind == 3:
            lane[m] = [p if l % 2 == 0 else _neg(ncomp, g[l - 1])
                       for l, p in enumerate(g)]
        elif kind == 4:
            lane[m] = [None] * (L - 1) + [g[0]]
        elif kind == 5:
            lane[m] = [g[0]] + [None] * (L - 1)
        elif kind == 6:
            lane[m] = [p if l % 2 else None for l, p in enumerate(g)]
    flat = [lane[m][l] for l in range(L) for m in range(lanes)]
    return _rows(ncomp, flat, rng).reshape(L, lanes, 3, ncomp, 16)


PREFIX_KS = (1, 5, 32, 64)     # K2's planted step counts (5 is ragged)


def prefix_affine(ncomp, k, lanes, seed):
    """K2's mixed-mode input (k, lanes, 2, ncomp, 16), affine, a pattern per
    lane (lane % 4): one point repeated (every add a doubling), P and -P
    alternating (the prefix cancels to O and restarts), random with step j
    + 1 repeating step j at every third j, all random."""
    base = _points(ncomp, k * lanes, seed)
    lane = [[base[l * lanes + m] for l in range(k)] for m in range(lanes)]
    for m, g in enumerate(lane):
        kind = m % 4
        if kind == 0:
            lane[m] = [g[0]] * k
        elif kind == 1:
            lane[m] = [g[0] if l % 2 == 0 else _neg(ncomp, g[0])
                       for l in range(k)]
        elif kind == 2:
            lane[m] = [g[l - 1] if l % 3 == 1 else p
                       for l, p in enumerate(g)]
    flat = [lane[m][l] for l in range(k) for m in range(lanes)]
    rows = _rows(ncomp, flat, random.Random(seed), affine=True)
    return rows[:, :2].reshape(k, lanes, 2, ncomp, 16).contiguous()


def horner_windows(ncomp, W, c, seed):
    """K6's planted window sums {variant: (S (W, 3, ncomp, 16), c)}: random
    points; every S_w the identity; the top two windows identities with
    random nonzero X and Y; S_(W-2) = 2^c S_(W-1) (the add after the top
    window's doublings takes the doubling branch) and S_(W-4) the negated
    sum it meets (that add cancels to O); every S_w equal at c = 0 (a
    doubling at every add). W >= 4."""
    rng = random.Random(seed)
    ks = [rng.randrange(1, FR_MOD) for _ in range(W)]
    ks[W - 2] = ks[W - 1] << c                  # scalars of the sums met
    acc = ((ks[W - 1] << (2 * c + 1)) + ks[W - 3]) << c
    ks[W - 4] = -acc
    mul = (native_bridge.g1_gen_mul_batch if ncomp == 1
           else native_bridge.g2_gen_mul_batch)
    pts = mul([k % FR_MOD for k in ks])
    rand = _rows(ncomp, _points(ncomp, W, seed + 1), rng)
    top = rand.clone()
    top[W - 2:, :2] = torch.as_tensor(FP.to_mont(
        [[[rng.randrange(1, FP_MOD) for _ in range(ncomp)]
          for _ in range(2)] for _ in range(2)]))
    top[W - 2:, 2] = 0
    return {"random": (rand, c), "identity": (torch.zeros_like(rand), c),
            "top-identity": (top, c), "doubling": (_rows(ncomp, pts, rng), c),
            "equal": (_rows(ncomp, [pts[0]] * W, rng), 0)}


def kernel_inputs(ncomp, device, lanes=1024, k=4, Ls=WSUM_LS, W=4,
                  wlanes=64, seed=5, Ks=PREFIX_KS, HW=6):
    """Small inputs of every kernel (lane-major pairs across steps carry
    the P = Q / P = -Q cases into the scans)."""
    rng = random.Random(seed + ncomp)
    n = k * lanes
    base = _points(ncomp, n, seed + 10 * ncomp)
    # scans: lane l's step-1 point repeats (or negates) its step-0 point
    scan = list(base)
    for l in range(0, lanes, 4):
        scan[lanes + l] = scan[l]
        scan[lanes + l + 1] = _neg(ncomp, scan[l + 1])
    aff = _rows(ncomp, scan, rng, affine=True)[:, :2]
    jac = _rows(ncomp, _special(ncomp, base), rng)
    signs = [rng.randrange(2) for _ in range(n)]
    dev = lambda t: t.to(device).contiguous()
    a = jac[:lanes]
    b = _rows(ncomp, _special(ncomp, base[lanes:2 * lanes]), rng)
    b[::7] = a[::7]                                  # a = b: doubling
    b[3::11] = _rows(ncomp, [None if p is None else _neg(ncomp, p)
                             for p in _affine(ncomp, a[3::11])], rng)
    return dict(
        addn=addn_planted(ncomp, jac, rng, device),
        scale={s: tuple(map(dev, scale_planted(ncomp, base[:64], s, rng)))
               for s in SCALE_SS},
        xy=dev(aff),
        payload=dev(prefix_payload(rng, W, k, lanes, signs)),
        tiles={(kk, mixed): dev(
            prefix_affine(ncomp, kk, wlanes, seed + 3 * kk) if mixed
            else wsum_steps(ncomp, kk, wlanes, rng, seed + 2 * kk))
            for kk in Ks for mixed in (True, False)},
        steps={L: dev(wsum_steps(ncomp, L, wlanes, rng, seed + L))
               for L in Ls},
        a=dev(a), b=dev(b),
        horner={v: (dev(S), c) for v, (S, c) in horner_windows(
            ncomp, HW, 13, seed + 40).items()},
    )


def addn_planted(ncomp, jac, rng, device):
    """K4's gathered modes on n = len(jac) rows: the source rows ``src``
    (``jac`` with identities of nonzero X and Y in rows 5 mod 16 and Y = 0
    in rows 6 mod 16), a second source ``other`` (the rows reversed), and
    int64 index vectors of n: ``ia``/``ib`` random with -1 (a row of zeros)
    at about one in eight, ``same`` (row i: A = B, a doubling; with neg_b a
    cancelling add), and a bool mask ``zero`` at about one in five."""
    n = jac.shape[0]
    src = jac.clone()
    src[5::16, :2] = torch.as_tensor(FP.to_mont(
        [[[rng.randrange(1, FP_MOD) for _ in range(ncomp)]
          for _ in range(2)] for _ in range(len(src[5::16]))]))
    src[5::16, 2] = 0
    src[6::16, 1] = 0
    idx = lambda: torch.tensor([rng.randrange(n) if rng.randrange(8)
                                else -1 for _ in range(n)])
    dev = lambda t: t.to(device).contiguous()
    return dict(src=dev(src), other=dev(src.flip(0)), ia=dev(idx()),
                ib=dev(idx()), same=dev(torch.arange(n)),
                zero=dev(torch.tensor([rng.randrange(5) == 0
                                       for _ in range(n)])))


SCALE_SS = (0, 1, 7)           # K5's planted doubling counts


def scale_planted(ncomp, pts, s, rng):
    """K5's rows (a, b) for 2^s a + b, pattern by row % 8: b = 2^s a (the
    add doubles), b = -2^s a (it cancels), b the identity, a the identity,
    both identities with nonzero X and Y, random (three kinds)."""
    add = pr.g1_add if ncomp == 1 else pr.g2_add
    a, b = list(pts), [pts[(i + 3) % len(pts)] for i in range(len(pts))]
    for i, p in enumerate(pts):
        kind = i % 8
        if kind in (0, 1):
            q = p
            for _ in range(s):
                q = add(q, q)
            b[i] = q if kind == 0 else _neg(ncomp, q)
        elif kind == 2:
            b[i] = None
        elif kind in (3, 4):
            a[i] = None
    ra, rb = _rows(ncomp, a, rng), _rows(ncomp, b, rng)
    for r in (ra, rb):
        r[4::8, :2] = torch.as_tensor(FP.to_mont(
            [[[rng.randrange(1, FP_MOD) for _ in range(ncomp)]
              for _ in range(2)] for _ in range(len(r[4::8]))]))
        r[4::8, 2] = 0
    return ra, rb


def _affine(ncomp, rows):
    """Point rows (..., 3, ncomp, 16) -> affine ints (None = identity)."""
    to_aff = tp._g1_affine if ncomp == 1 else tp._g2_affine
    return [to_aff(tuple(r[:, 0] if ncomp == 1 else r))
            for r in rows.reshape(-1, 3, ncomp, 16).cpu()]


def kernel_cases(inp):
    """(name, variant, kernel call, plain call) for every kernel mode."""
    xy, pv = inp["xy"], inp["payload"]
    prefixes = [(f"k={k} {'mixed' if mixed else 'jacobian'}{m}",
                 (lambda t=t, mixed=mixed, c=c: kernels.prefix(t, mixed, c)),
                 (lambda t=t, mixed=mixed, c=c: grid.prefix_plain(t, mixed,
                                                                  c)))
                for (k, mixed), t in inp["tiles"].items()
                for c, m in ((True, ""), (False, "-incomplete"))
                if mixed or c]
    wsums = [(f"L={L}", (lambda st=st: kernels.wsum(st)),
              (lambda st=st: grid.wsum_plain(st)))
             for L, st in inp["steps"].items()]
    by_c = {}                  # K6's twin runs the variants of one c at once

    def horner_want(v):
        c = inp["horner"][v][1]
        if c not in by_c:
            vs = [u for u, (_, cu) in inp["horner"].items() if cu == c]
            S = torch.stack([inp["horner"][u][0] for u in vs])
            by_c[c] = dict(zip(vs, grid.horner_plain(S, c)))
        return by_c[c][v]

    horners = [(f"{v} c={c}", (lambda S=S, c=c: kernels.horner(S, c)),
                (lambda v=v: horner_want(v)))
               for v, (S, c) in inp["horner"].items()]
    return [
        ("prefix_rows", "complete",
         lambda: kernels.prefix_rows(xy, pv, True),
         lambda: grid.prefix_rows_plain(xy, pv, True)),
        ("prefix_rows", "incomplete",
         lambda: kernels.prefix_rows(xy, pv, False),
         lambda: grid.prefix_rows_plain(xy, pv, False)),
    ] + [("prefix", v, kern, plain) for v, kern, plain in prefixes] + [
        ("wsum", v, kern, plain) for v, kern, plain in wsums] + [
        ("addn", "plain",
         lambda: kernels.addn(inp["a"], inp["b"]),
         lambda: grid.addn_plain(inp["a"], inp["b"])),
    ] + [("addn", v, (lambda kw=kw: kernels.addn(**kw)),
          (lambda kw=kw: grid.addn_plain(**kw)))
         for v, kw in addn_modes(inp["addn"]).items()] + [
        ("scale_add", f"s={s}",
         (lambda a=a, b=b, s=s: kernels.scale_add(a, b, s)),
         (lambda a=a, b=b, s=s: grid.scale_add_plain(a, b, s)))
        for s, (a, b) in inp["scale"].items()
    ] + [("horner", v, kern, plain) for v, kern, plain in horners]


def addn_modes(g):
    """K4's gathered modes on ``addn_planted``'s rows: {variant: kwargs}."""
    src, other, same = g["src"], g["other"], g["same"]
    return {
        "sentinel a": dict(a=src, b=other, ia=g["ia"]),
        "sentinel b": dict(a=src, b=other, ib=g["ib"]),
        "sentinels, zero mask": dict(a=src, b=other, ia=g["ia"], ib=g["ib"],
                                     zero=g["zero"]),
        "neg_b (Y = 0 rows)": dict(a=other, b=src, ia=g["ia"], ib=g["ib"],
                                   neg_b=True),
        "equal operands": dict(a=src, b=src, ia=same, ib=same),
        "opposite operands": dict(a=src, b=src, ia=same, ib=same,
                                  neg_b=True),
        "plain, neg_b, zero mask": dict(a=src, b=other, neg_b=True,
                                        zero=g["zero"]),
    }


# K8's planted kinds: pair i is of kind (i + offset) % 16 (the rest random)
TREE_KINDS = {1: "P = Q", 2: "P = -Q", 3: "INF_L", 4: "INF_R", 5: "both INF",
              6: "x equal, y unrelated", 7: "P = Q under INF_L",
              8: "P = -Q under INF_R", 9: "P = Q under both"}


def tree_pairs(M, device, seed=8, offset=0, pool_n=4096):
    """M pairs for K8: affine Montgomery rows L, R int64[M, 32] (x limbs,
    then y limbs) and flags int64[M] (1 = L is infinity, 2 = R is), L and R
    distinct points of a pool of min(2M, pool_n) seeded points, with pair i
    of kind (i + offset) % 16 planted as ``TREE_KINDS`` says: a doubling, a
    cancelling pair (a zero denominator in complete mode; P = Q gives one in
    incomplete mode), each infinity flag, x equal with an unrelated y, and
    the doubling or cancelling under an INF bit."""
    n = min(2 * M, pool_n)
    rng = random.Random(seed)
    pool = torch.as_tensor(FP.to_mont(_points(1, n, seed))).reshape(n, 32)
    i = torch.arange(M)
    L = pool[(2 * i) % n]
    R = pool[(2 * i + 1) % n]
    negL = torch.cat([L[:, :16], FP.neg(L[:, 16:])], 1)
    kind = (i + offset) % 16
    fl = torch.zeros(M, dtype=torch.int64)
    for k, rows, f in ((1, L, 0), (2, negL, 0), (7, L, 1), (8, negL, 2),
                       (9, L, 3)):
        R = torch.where((kind == k)[:, None], rows, R)
        fl = torch.where(kind == k, f, fl)
    for k, f in ((3, 1), (4, 2), (5, 3)):
        fl = torch.where(kind == k, f, fl)
    six = (kind == 6).nonzero().flatten()
    if len(six):
        ys = torch.as_tensor(FP.to_mont([rng.randrange(FP_MOD)
                                         for _ in range(len(six))]))
        R[six] = torch.cat([L[six, :16], ys], 1)
    return L.to(device), R.contiguous().to(device), fl.to(device)


# K7's batch sizes and widths held through the wrapper's layout choice
POSEIDON_BS = (1, 2, 31, 64, 4096, 1 << 15)
POSEIDON_TS = (2, 3, 5, 17)
# K8's pair counts held in both modes (with M = 1 once a planted kind)
TREE_MS = (40, 1023, 1025)


def check_kernels(device, lanes=1024, k=4, Ls=WSUM_LS, W=4, wlanes=64,
                  B=256, pairs=4096, Ks=PREFIX_KS, poseidon_bs=POSEIDON_BS,
                  tree_ms=TREE_MS + ("level0",)):
    """Every kernel mode, Fp and Fp2 (K1 over W windows; K2 at each k of
    ``Ks`` and K3 at each L of ``Ls``, on ``wlanes`` planted lanes; K6 on
    planted windows), against its plain twin on ``device``: K7 at every
    width t = 2 .. 17 at batch B in each layout built for it, and at each
    batch of ``poseidon_bs`` for t = 2, 3, 5, 17 in the layout the wrapper
    picks; K8 in both modes at M = 1 once a planted kind, at each M of
    ``tree_ms`` ("level0": the prover's level 0, 163,840 pairs) and at
    ``pairs``. Returns {(name, ncomp or t, variant): max |kernel - plain|
    over the limbs and flags}."""
    errs = {}

    def held(key, got, want):
        if got[0].is_cuda:
            torch.cuda.synchronize()
        errs[key] = max(int((g - w).abs().max().item())
                        for g, w in zip(got, want))

    for ncomp in (1, 2):
        inp = kernel_inputs(ncomp, device, lanes, k, Ls, W, wlanes, Ks=Ks)
        for name, variant, kern, plain in kernel_cases(inp):
            held((name, ncomp, variant), [kern()], [plain()])
    sms = _sms(device)
    # poseidon_special(t, b) is the first b rows of poseidon_special(t, big),
    # so the plain version runs once a width on the largest batch
    big = max((B,) + tuple(poseidon_bs))
    wide = {t: poseidon_special(t, big, device) for t in POSEIDON_TS}
    wide = {t: (x, poseidon.hash_n_plain(x)) for t, x in wide.items()}
    for t in hkern.WIDTHS:
        x, want = wide.get(t) or (poseidon_special(t, B, device), None)
        x = x[:B].contiguous()
        want = poseidon.hash_n_plain(x) if want is None else want[:B]
        for lay in _layouts(t):
            held(("poseidon", t, f"B={B} {_layout_name(lay)}"),
                 [hkern._launch(x, t, lay, 32)], [want])
    for t in POSEIDON_TS:
        for b in poseidon_bs:
            x = wide[t][0][:b].contiguous()
            lay = _layout_name(hkern.layout(b, t, sms)[0])
            held(("poseidon", t, f"B={b} {lay}"), [hkern.hash_tiles(x, t)],
                 [wide[t][1][:b]])
    mode = {True: " complete", False: " incomplete"}
    # the twin adds each pair on its own, so the planted kinds' M = 1
    # launches are held to one plain call over all of them a mode
    ones = {o: tree_pairs(1, device, offset=o) for o in TREE_KINDS}
    stacked = [torch.cat(ts) for ts in zip(*ones.values())]
    for complete in (True, False):
        out, inf = affine_tree.tree_level_plain(*stacked, complete)
        for i, (o, pair) in enumerate(ones.items()):
            held(("tree_level", 1, f"M=1 {TREE_KINDS[o]}{mode[complete]}"),
                 tkern.tree_level(*pair, complete),
                 (out[i:i + 1], inf[i:i + 1]))
    for M in [tree_widths()[0] if m == "level0" else m
              for m in tree_ms + (pairs,)]:
        Lr, Rr, fl = tree_pairs(M, device)
        for complete in (True, False):
            held(("tree_level", 1, f"M={M}{mode[complete]}"),
                 tkern.tree_level(Lr, Rr, fl, complete),
                 affine_tree.tree_level_plain(Lr, Rr, fl, complete))
    return errs


def _layouts(t):
    """K7's built layouts of width t: G lanes a hash, and one thread a hash
    up to THREAD_MAX_T."""
    return (hkern.group_lanes(t),) + ((0,) if t <= hkern.THREAD_MAX_T else ())


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _layout_name(lanes):
    return f"lanes G={lanes}" if lanes else "thread"


# ------------------------------------------------- product microbenchmark

MUL_FORMS = ("a out-of-line", "b inlined C", "c inlined PTX",
             "d 3 chains C", "d 3 chains PTX", "e out-of-line PTX",
             "f 3 chains on 3 lanes", "g a product on 4 lanes",
             "g a product on 8 lanes")
# the forms K2 and K6 run: K2 one thread's fp_mul_fast (e), K6 a level of
# products on the lanes of one warp (f); (g), one product split over 4 or 8
# lanes, is timed over Fp only
K2_FORM, K6_FORM = 5, 6
LANE_FORMS = (7, 8)


def time_products(device, n=4096, reps=3):
    """One thread (forms f, g: one warp) walking a dependent chain of n
    Montgomery products (``csrc/mul_bench.cu``), Fp and Fp2, in each of the
    seven forms (a)-(f), and over Fp form (g) at 4 and 8 lanes a product:
    the best of ``reps`` launches by CUDA events, in us a product (a step
    of the three-chain forms holds three products: ``us_step`` is the
    step, ``us`` the step over 3) and in clock64 cycles a step. Every form
    must end on the limbs of form (a). Returns {(ncomp, form): dict}."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = cuda_build.load("mul_bench.cu", {"mul_chain": [P, P, P, I, I, I,
                                                         P]})
    rng = random.Random(55)
    res = {}
    for ncomp in (1, 2):
        pair = FP.to_mont([[[rng.randrange(FP_MOD) for _ in range(ncomp)]
                            for _ in range(2)]])[0]
        inp = torch.as_tensor(np.stack([pair] * 3), device=device)
        want = None
        for form in range(len(MUL_FORMS)):
            if ncomp == 2 and form in LANE_FORMS:
                continue
            out = torch.empty((3, ncomp, 16), dtype=torch.int64,
                              device=device)
            cyc = torch.zeros(1, dtype=torch.int64, device=device)
            times = []
            for _ in range(reps + 1):              # the first one warms up
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                rc = lib.mul_chain(inp.data_ptr(), out.data_ptr(),
                                   cyc.data_ptr(), n, ncomp, form,
                                   ctypes.c_void_p(torch.cuda.current_stream(
                                       device).cuda_stream))
                t1.record()
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"mul_chain form {form}: CUDA error "
                                       f"{rc}")
                times.append(t0.elapsed_time(t1))
            best = min(times[1:])
            if want is None:
                want = out[0].clone()
            step_us = best * 1e3 / n
            per = 3 if form in (3, 4, 6) else 1
            res[(ncomp, form)] = dict(
                form=MUL_FORMS[form], us=step_us / per, us_step=step_us,
                cycles_step=int(cyc.item()) / n,
                max_abs_err=int((out - want).abs().max().item()))
    return res


INV_FORMS = ("i Fermat, fp_mul", "ii Fermat, 4-bit window and squares",
             "iii safegcd", "square by fp_mul", "square by fp_sqr")
K8_INV_FORM = 2      # K8 runs fp_inv, form (iii)


def time_inverses(device, n_inv=16, n_sqr=4096, reps=3):
    """One thread walking a dependent chain (``csrc/mul_bench.cu``
    inv_chain): n_inv inversions x <- x^-1 + y in each form, (i) Fermat
    with fp_mul, (ii) Fermat with a 4-bit window and dedicated squares,
    (iii) field.cuh's safegcd (K8's); then n_sqr squares x <- x^2 by fp_mul
    and by fp_sqr. The best of ``reps`` launches by CUDA events, in us a
    step and clock64 cycles a step. Forms (ii) and (iii) must end on form (i)'s
    limbs, the dedicated square on fp_mul's. Returns {form: dict}."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = cuda_build.load("mul_bench.cu", {"inv_chain": [P, P, P, I, I, P]})
    rng = random.Random(56)
    inp = torch.as_tensor(FP.to_mont([rng.randrange(1, FP_MOD)
                                      for _ in range(2)]), device=device)
    res, want = {}, {}
    for form, name in enumerate(INV_FORMS):
        n = n_inv if form < 3 else n_sqr
        out = torch.empty(16, dtype=torch.int64, device=device)
        cyc = torch.zeros(1, dtype=torch.int64, device=device)
        times = []
        for _ in range(reps + 1):                  # the first one warms up
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            rc = lib.inv_chain(inp.data_ptr(), out.data_ptr(), cyc.data_ptr(),
                               n, form, ctypes.c_void_p(
                                   torch.cuda.current_stream(device)
                                   .cuda_stream))
            t1.record()
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"inv_chain form {form}: CUDA error {rc}")
            times.append(t0.elapsed_time(t1))
        ref = want.setdefault(form < 3, out.clone())
        res[form] = dict(form=name, us=min(times[1:]) * 1e3 / n,
                         cycles=int(cyc.item()) / n,
                         max_abs_err=int((out - ref).abs().max().item()))
    return res


# ------------------------------------------------------------ Poseidon K7

def poseidon_special(t, B, device, seed=9):
    """B rows of t - 1 Montgomery inputs: seeded random values, with 0, 1
    and r - 1 planted alone and mixed in the first rows."""
    r = FR.modulus
    rng = random.Random(seed + t)
    rows = [[rng.randrange(r) for _ in range(t - 1)] for _ in range(B)]
    special = [0, 1, r - 1]
    for i in range(min(B, 12)):
        rows[i] = [special[(i + w * (i // 3)) % 3] for w in range(t - 1)]
    return torch.as_tensor(FR.to_mont(rows), device=device).contiguous()


def random_mont(shape, device, seed):
    """Seeded canonical Montgomery Fr limbs made on the device (top limb
    below r's, so every value is < r)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=g,
                      device=device, dtype=torch.int64)
    x[..., 15] %= FR.modulus >> 240
    return x


# 32-bit multiply-adds of one Fr product's parts: the unreduced product of
# two 8-word values (64 word products, lo and hi), a square's (36 distinct
# word products), and one Montgomery reduction (64 word products and 8
# quotient words). A full product is 128 + 136 = MADDS_PER_FP_MUL.
MADDS_WIDE, MADDS_WIDE_SQR, MADDS_REDC = 2 * 64, 2 * 36, 2 * 64 + 8


def poseidon_madds(t):
    """32-bit multiply-adds of one hash in the least form known: x^5 as two
    squares and one product; each mix lazy (unreduced products summed, one
    reduction per output); the partial rounds in the sparse form of the
    Poseidon paper's appendix B (the last first-half full round mixes with
    the dense pre-matrix, each partial round with a matrix of 2t - 1
    nonzero entries); the last mix computes wire 0 alone."""
    r_p = N_ROUNDS_P[t - 2]
    sbox = 2 * (MADDS_WIDE_SQR + MADDS_REDC) + MADDS_WIDE + MADDS_REDC
    dense = t * t * MADDS_WIDE + t * MADDS_REDC
    sparse = (2 * t - 1) * MADDS_WIDE + t * MADDS_REDC
    last = t * MADDS_WIDE + MADDS_REDC
    return ((N_ROUNDS_F * t + r_p) * sbox + (N_ROUNDS_F - 1) * dense
            + r_p * sparse + last)


def poseidon_bound(t, B, clock_hz):
    """(bound ms, bound_by) of B hashes of width t: multiply-adds over the
    INT32 rate against (t - 1) input rows and one output row of int64
    limbs over the memory rate."""
    ops_s = B * poseidon_madds(t) / (INT32_LANES * clock_hz)
    bytes_s = B * t * 16 * 8 / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def poseidon_floor(t, lanes, products, inverses):
    """(product levels, floor ms) of one hash's chain, the latency floor of
    a launch: in the lane layout R_F full rounds of two squares, a product
    and the lane's lazy mix (t unreduced products, a reduction a group of
    5), and 3 product levels a partial round, a level at form f's time (a
    level's products on the lanes of a warp); one thread a hash runs every
    multiply-add of the hash in one thread (``poseidon_madds``, in products
    at form a's time)."""
    mul = products[(1, 0)]["us"]
    if not lanes:
        levels = poseidon_madds(t) / MADDS_PER_FP_MUL
        return levels, levels * mul / 1e3
    sqr, lvl = inverses[4]["us"], products[(1, K6_FORM)]["us_step"]
    mix = (t * MADDS_WIDE + -(-t // 5) * MADDS_REDC) / MADDS_PER_FP_MUL
    r_p = N_ROUNDS_P[t - 2]
    us = N_ROUNDS_F * (2 * sqr + mul + mix * mul) + 3 * r_p * lvl
    return N_ROUNDS_F * (3 + mix) + 3 * r_p, us / 1e3


def time_poseidon(device, clock_hz, products, inverses, B=1 << 15):
    """K7 for t = 3, 4, 5 at batch B (the top level of the 2^16 tree is
    hash2 x 32,768): its output against the plain twin's on the same inputs,
    the ms of both, the bound and the chain floor of the layout the wrapper
    picks."""
    res = {}
    for t in (3, 4, 5):
        x = random_mont((B, t - 1), device, seed=70 + t)
        ms, got = _cuda_ms(lambda: hkern.hash_tiles(x, t), 50)
        plain_ms, want = _cuda_ms(lambda: poseidon.hash_n_plain(x), 1,
                                  warm=False)
        bound_ms, bound_by = poseidon_bound(t, B, clock_hz)
        lanes = hkern.layout(B, t, _sms(device))[0]
        levels, floor_ms = poseidon_floor(t, lanes, products, inverses)
        res[("poseidon", t)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            shape=(B, t - 1), layout=_layout_name(lanes),
            chain_levels=round(levels, 1), floor_ms=floor_ms,
            max_abs_err=int((got - want).abs().max().item()))
    return res


def time_poseidon_widths(device, B=1 << 15, B2=1 << 13):
    """K7 alone at every width t = 2 .. 17, B hashes: {t: ms} (CUDA
    events, 20 launches), and {t: {B or B2: each built layout's ms}}."""
    ms = {t: _cuda_ms(lambda x=random_mont((B, t - 1), device, seed=80 + t):
                      hkern.hash_tiles(x, t), 20)[0] for t in hkern.WIDTHS}
    return ms, {t: time_poseidon_layouts(device, t, (B, B2), reps=5)
                for t in hkern.WIDTHS}


def time_poseidon_layouts(device, t, widths, reps=20):
    """K7 of width t at each batch of ``widths`` in each built layout,
    and the wrapper's choice: {B: {"lanes": ms, "thread": ms, "chosen":
    layout}} (CUDA events around a CUDA graph of ``reps`` launches)."""
    res, sms = {}, _sms(device)
    for b in widths:
        x = random_mont((b, t - 1), device, seed=50 + b % 97)
        res[b] = {_layout_name(lay).split()[0]: _graph_ms(
            lambda lay=lay: hkern._launch(x, t, lay, hkern.block_size(
                b * (lay or 1), sms)), reps)[0]
            for lay in _layouts(t)}
        res[b]["chosen"] = _layout_name(hkern.layout(b, t, sms)[0])
    return res


# ------------------------------------------------------------ timings

def _cuda_ms(fn, reps, warm=True):
    """(mean ms of ``reps`` calls by CUDA events, the last call's output)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, out


def _graph_ms(fn, reps, replays=3):
    """(mean ms of ``reps`` calls captured in one CUDA graph and replayed
    ``replays`` times: the device's time without the host's launch gaps,
    the last call's output). ``fn`` runs once outside the graph first."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    return _cuda_ms(graph.replay, replays)[0] / reps, out


def _times_err(t):
    """A timed row's max |kernel - twin|, with its second shape's and its
    other modes'."""
    return max(u["max_abs_err"] for u in _timed(t))


def _timed(t):
    """A timed row and the rows riding on it (second shape, modes)."""
    return [t] + ([t["level2"]] if "level2" in t else []) + list(
        t.get("modes", {}).values())


def _host_ms(fn, reps=1):
    """(mean ms of ``reps`` calls by the host clock, synchronized around
    them; the last call's output)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def slice_shapes(ncomp):
    """Each kernel's input shape in the withdraw-scale prover (c = 13, W =
    20 windows; a G1 leg of 16,384 points = 16 steps of 1,024 lanes, the G2
    leg 9,216 = 9 steps; half = 4,096 buckets as C = 32 chunks of L = 128).
    K1 is one launch over the W windows; K2 runs on the real lanes, (k,
    lanes) = (32, W * 1,024 / 32) = (32, 640) and (``prefix2``) (32, W) =
    (32, 20); K3 at (L, W C) = (128, 640) and once more at (C, 2 W) = (32,
    40) (``wsum2``: T and U together)."""
    return dict(prefix_rows=(20, 16 if ncomp == 1 else 9, 1024),
                prefix=(32, 640), prefix2=(32, 20), wsum=(128, 640),
                wsum2=(32, 40), addn=81920, scale_add=20, horner=20)


# Dependent product levels of each point formula (csrc/point.cuh).
LEVELS = {"pdouble": 3, "padd": 5, "pmadd": 5}


def chain_floor(name, shape, mul_us, c=13, s=7):
    """(levels, floor ms) of K2, K5 or K6: the dependent product levels on
    the kernel's longest chain times the time of one level (``mul_us``,
    the microbenchmark's: K5 and K6 form f, a level's products on a warp's
    lanes; K2 form e, one product). K6: (W - 1) c doublings and W adds; K5:
    s doublings and one add; K2: a segment's s - 1 adds, ceil(log2 T) scan
    adds and the carry add."""
    if name == "horner":
        levels = (shape - 1) * c * LEVELS["pdouble"] + shape * LEVELS["padd"]
    elif name == "scale_add":
        levels = s * LEVELS["pdouble"] + LEVELS["padd"]
    else:
        T, log2s = grid.prefix_schedule(shape[0])
        adds = (1 << log2s) - 1 + (T - 1).bit_length() + (T > 1)
        levels = adds * LEVELS["padd"]
    return levels, levels * mul_us / 1e3


def addn_work(ncomp, a, b, ia=None, ib=None, neg_b=False, zero=None):
    """(Fp products, bytes) one K4 call needs on these inputs: a complete
    add a row the mask leaves; each source row an index reaches read once
    (a and b as one source where they are one tensor), the indices and the
    mask read once, every output row written once."""
    row = 3 * ncomp * 16 * 8
    n = next((t.shape[0] for t in (ia, ib, zero) if t is not None),
             a.shape[0])
    adds = n - (int(zero.sum().item()) if zero is not None else 0)
    ra, rb = (torch.arange(n, device=a.device) if i is None else i[i >= 0]
              for i in (ia, ib))
    rows = (ra.unique().numel() + rb.unique().numel()
            if a.data_ptr() != b.data_ptr()
            else torch.cat([ra, rb]).unique().numel())
    nbytes = (rows + n) * row + 8 * sum(
        t.shape[0] for t in (ia, ib) if t is not None) + (
        n if zero is not None else 0)
    return adds * _fp_products("padd", ncomp), nbytes


def _bound_of(muls, nbytes, clock_hz):
    ops_s = muls * MADDS_PER_FP_MUL / (INT32_LANES * clock_hz)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _bound(name, ncomp, shape, clock_hz):
    """(bound ms, bound_by) for one call: max of the 32-bit multiply-adds
    over the card's INT32 rate and the bytes over its memory rate."""
    madd, add, dbl = (_fp_products(f, ncomp)
                      for f in ("pmadd", "padd", "pdouble"))
    row = 3 * ncomp * 16 * 8                    # one int64-limb point row
    if name == "prefix_rows":
        # one mixed add a (window, step, lane); the N = k * lanes affine
        # source rows read once, the payload and the prefix rows once
        W, k, lanes = shape
        muls = W * k * lanes * madd
        nbytes = k * lanes * 2 * row // 3 + W * k * lanes * (8 + row)
    elif name == "prefix":
        k, lanes = shape
        muls = k * lanes * add
        nbytes = 2 * k * lanes * row
    elif name == "wsum":
        L, lanes = shape
        muls = 2 * L * lanes * add
        nbytes = (L + 2) * lanes * row
    elif name == "addn":
        muls = shape * add
        nbytes = 3 * shape * row
    elif name == "scale_add":
        muls = shape * (7 * dbl + add)
        nbytes = 3 * shape * row
    else:                                       # horner, W = shape, c = 13
        muls = shape * (13 * dbl + add)
        nbytes = (shape + 1) * row
    return _bound_of(muls, nbytes, clock_hz)


def time_kernels(device, clock_hz, products):
    """Every kernel at the slice's shapes: its output against the plain
    twin's on the same inputs (``max_abs_err`` over the limbs), and the ms
    of both; K2 and K6 also their chain floor from ``products`` (the
    microbenchmark's, in the form K2 and K6 run)."""
    rng = random.Random(3)
    res = {}
    for ncomp in (1, 2):
        shp = slice_shapes(ncomp)
        pts = _points(ncomp, 4096, 77 + ncomp)
        pool = _rows(ncomp, pts, rng).to(device)
        pool_aff = _rows(ncomp, pts, rng, affine=True).to(device)

        def take(n, C=3, src=pool):
            idx = torch.arange(n, device=device) % src.shape[0]
            return src[idx][:, :C].contiguous()

        W1, k1, l1 = shp["prefix_rows"]
        n1 = k1 * l1
        xy = take(n1, 2, pool_aff)
        gen = torch.Generator(device=device)
        gen.manual_seed(11 + ncomp)
        perm = torch.stack([torch.randperm(n1, generator=gen, device=device)
                            for _ in range(W1)])
        neg = (torch.arange(W1 * n1, device=device) % 3 == 0).long()
        payload = (perm | (neg.reshape(W1, n1) << 31)).reshape(W1, k1, l1)
        k2, l2 = shp["prefix"]
        tiles = take(k2 * l2).reshape(k2, l2, 3, ncomp, 16)
        k2b, l2b = shp["prefix2"]
        tiles2 = take(k2b * l2b).roll(3, 0).reshape(k2b, l2b, 3, ncomp, 16)
        L3, l3 = shp["wsum"]
        steps = take(L3 * l3).reshape(L3, l3, 3, ncomp, 16)
        L3b, l3b = shp["wsum2"]
        steps2 = take(L3b * l3b).roll(5, 0).reshape(L3b, l3b, 3, ncomp, 16)
        na = shp["addn"]
        a4, b4 = take(na), take(na).roll(1, 0).contiguous()
        legs = leg_addn_calls(ncomp, device, take)
        n5 = shp["scale_add"]
        a5, b5 = take(n5), take(n5).roll(1, 0).contiguous()
        S6 = take(shp["horner"])
        calls = {
            "prefix_rows": (lambda: kernels.prefix_rows(xy, payload, True),
                            lambda: grid.prefix_rows_plain(xy, payload,
                                                           True)),
            "prefix": (lambda: kernels.prefix(tiles, False, True),
                       lambda: grid.prefix_plain(tiles, False, True)),
            "prefix2": (lambda: kernels.prefix(tiles2, False, True),
                        lambda: grid.prefix_plain(tiles2, False, True)),
            "wsum": (lambda: kernels.wsum(steps),
                     lambda: grid.wsum_plain(steps)),
            "wsum2": (lambda: kernels.wsum(steps2),
                      lambda: grid.wsum_plain(steps2)),
            "addn": (lambda: kernels.addn(a4, b4),
                     lambda: grid.addn_plain(a4, b4)),
            "scale_add": (lambda: kernels.scale_add(a5, b5, 7),
                          lambda: grid.scale_add_plain(a5, b5, 7)),
            "horner": (lambda: kernels.horner(S6, 13),
                       lambda: grid.horner_plain(S6, 13)),
        }
        for name, (kern, plain) in calls.items():
            ms, got = _cuda_ms(kern, 50)
            plain_ms, want = _cuda_ms(plain, 1, warm=False)
            base = name.rstrip("2")
            bound_ms, bound_by = _bound(base, ncomp, shp[name], clock_hz)
            res[(name, ncomp)] = r = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=shp[name],
                max_abs_err=int((got - want).abs().max().item()))
            if base == "prefix":
                r["chain_levels"], r["floor_ms"] = chain_floor(
                    base, shp[name], products[(ncomp, K2_FORM)]["us"])
            elif base in ("horner", "scale_add"):
                r["chain_levels"], r["floor_ms"] = chain_floor(
                    base, shp[name], products[(ncomp, K6_FORM)]["us_step"])
            if base == "scale_add":
                r["graph_ms"] = _graph_ms(kern, 50)[0]
        # K4 also in a CUDA graph (its device time without the host's
        # launch gaps), the card's clocks sampled while the graph replays
        (res[("addn", ncomp)]["graph_ms"], _), res[("addn", ncomp)]["smi"] = \
            smi_beside(lambda: _graph_ms(calls["addn"][0], 50, replays=60))
        # K4's gathered calls of a leg, in its order (each call's output
        # feeds the next)
        modes = res[("addn", ncomp)]["modes"] = {}
        got = None
        for v, kw in legs.items():
            if v == "E":
                kw["a"] = got
            elif v == "B":
                kw["a"] = kw["b"] = got
            kern = lambda kw=kw: kernels.addn(**kw)
            ms, got = _cuda_ms(kern, 50)
            plain_ms, want = _cuda_ms(lambda: grid.addn_plain(**kw), 1,
                                      warm=False)
            n = got.shape[0]
            modes[v] = dict(zip(("bound_ms", "bound_by"), _bound_of(
                *addn_work(ncomp, **kw), clock_hz)), ms=ms,
                graph_ms=_graph_ms(kern, 50)[0], plain_ms=plain_ms,
                shape=f"{v}, {n} rows",
                max_abs_err=int((got - want).abs().max().item()))
        # K2's and K3's second shapes ride on their rows: {"level2": ...}
        for name in ("prefix", "wsum"):
            res[(name, ncomp)]["level2"] = res.pop((name + "2", ncomp))
    return res


def leg_addn_calls(ncomp, device, take, lanes=1024, c=13, seed=21):
    """K4's gathered calls of one prover leg (2^14 G1 or 9,216 G2 points,
    c = 13, 1,024 lanes) with the index vectors of a real leg: random
    scalars, their signed digits sorted, the bucket starts found as
    ``grid`` finds them; the prefix rows from ``take``. {"excl": kwargs,
    "E": kwargs, "B": kwargs}: E's ``a`` is excl's output and B's ``a``
    and ``b`` are E's, filled in by the caller."""
    n = 1 << 14 if ncomp == 1 else 9216
    W, half, k = grid.n_windows(c), 1 << (c - 1), n // lanes
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    limbs = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=device)
    limbs[:, 15] >>= 2                           # scalars below 2^254
    skeys = torch.sort(grid.signed_digits(limbs, c)[0], dim=0,
                       stable=True)[0]
    ex_i, pr_i, zm = grid.boundary_index(skeys, k, lanes, half)
    ia, ib = grid.excl_index(W, lanes, device)
    da, db = grid.diff_index(W, half, device)
    return {"excl": dict(a=take(W * lanes), b=take(W * lanes // 32), ia=ia,
                         ib=ib),
            "E": dict(a=None, b=take(W * n), ia=ex_i, ib=pr_i, zero=zm),
            "B": dict(a=None, b=None, ia=da, ib=db, neg_b=True)}


def smi_beside(fn, query="clocks.sm,power.draw,temperature.gpu"):
    """(fn(), nvidia-smi samples of ``query`` taken before it, while it
    runs, by a polling thread, and after it)."""
    samples = [nvidia_smi(query)]
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            samples.append(nvidia_smi(query))

    th = threading.Thread(target=poll)
    th.start()
    try:
        out = fn()
    finally:
        stop.set()
        th.join()
    samples.append(nvidia_smi(query))
    return out, samples


# ------------------------------------------------------------- phases

def phase_msm(device):
    """G1 MSM at 2^18 (two 2^17 slices folded through K4) and G2 at 2^14,
    against the native Pippenger oracle. Returns (results, the G1 inputs:
    affine ints, scalars, device points and limbs, the oracle's point)."""
    out = {}
    for ncomp, log2n, distinct in ((1, 18, 1 << 14), (2, 14, 1 << 12)):
        n = 1 << log2n
        rng = random.Random(100 + log2n)
        base = _points(ncomp, distinct, 200 + ncomp)
        pts = [base[i % distinct] for i in range(n)]
        for i in range(0, n, 997):
            pts[i] = None                               # identity rows
        ks = [rng.randrange(1, 1 << 254) for _ in range(n)]
        rows = _rows(ncomp, pts, rng, affine=True).to(device)
        limbs = torch.as_tensor(ints_to_limbs(ks), device=device)
        if ncomp == 1:
            pts_dev = tuple(rows[:, i, 0].contiguous() for i in range(3))
            msm, aff, oracle = (grid.msm_grid_g1, tp._g1_affine,
                                native_bridge.g1_msm)
        else:
            pts_dev = tuple(rows[:, i].contiguous() for i in range(3))
            msm, aff, oracle = (grid.msm_grid_g2, tp._g2_affine,
                                native_bridge.g2_msm)
        res = msm(pts_dev, limbs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = msm(pts_dev, limbs)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        got = aff(tuple(t.cpu() for t in res))
        pairs = [(k, p) for k, p in zip(ks, pts) if p is not None]
        want = oracle([k for k, _ in pairs], [p for _, p in pairs])
        out[ncomp] = dict(n=n, warm_ms=warm, ok=got == want)
        if ncomp == 1:
            g1 = dict(pts=pts, ks=ks, pts_dev=pts_dev, limbs=limbs, want=want)
    out["bench"] = bench_msm(device)
    return out, g1


def bench_msm(device, log2n=17):
    """The MSM benchmark's inputs (``benchvec``: ``random.Random(7)``, bases
    as exponents of the generator) at 2^log2n, through ``msm_grid_g1``,
    against the committed point of ``bench_expected.json``; s of the host
    arrays (built, or read from the disk cache), cold and warm ms."""
    t0 = time.perf_counter()
    X, Y, Z, L = benchvec.msm_device_arrays(log2n, device=device)
    torch.cuda.synchronize()
    arrays_s = time.perf_counter() - t0
    cold, _ = _host_ms(lambda: grid.msm_grid_g1((X, Y, Z), L))
    warm, res = _host_ms(lambda: grid.msm_grid_g1((X, Y, Z), L))
    got = tp._g1_affine(tuple(t.cpu() for t in res))
    want = benchvec.load_expected(log2n)
    return dict(n=1 << log2n, key=benchvec.expected_key(log2n),
                arrays_s=arrays_s, cold_ms=cold, warm_ms=warm,
                ok=want is not None and got == want)


def phase_merkle(device, clock_hz, products, inverses, log2n=16,
                 inserts=256, samples=64, profile=False):
    """The depth-16 tree at full capacity on the card, then a MerkleTree of
    host inserts; the K7 launches of both are this path's count.
    ``profile`` traces one warm 2^16 build."""
    n = 1 << log2n
    leaves = random_mont((n,), device, seed=16)
    hkern.reset_launches()            # the Merkle path starts here
    levels, root = build_levels(leaves, 16)
    torch.cuda.synchronize()
    build_launches = hkern.LAUNCHES["poseidon"]
    rng = random.Random(17)
    tree = MerkleTree(device=device)
    tree_leaves = [rng.randrange(FR.modulus) for _ in range(inserts)]
    for v in tree_leaves:
        tree.insert(v)
    idx = [0, 1, inserts - 1] + rng.sample(range(2, inserts - 1), 5)
    proofs = [tree.get_proof(i) for i in idx]
    launches = hkern.LAUNCHES["poseidon"]   # the Merkle path ends here

    info = dict(leaves=n, levels=len(levels), build_launches=build_launches,
                launches=launches)
    # every level against the plain twin of its children, on the card
    err = 0
    for k in range(1, len(levels)):
        lo = levels[k - 1]
        want = poseidon.hash_n_plain(torch.stack([lo[0::2], lo[1::2]], 1))
        err = max(err, int((levels[k] - want).abs().max().item()))
    info["max_abs_err"] = err
    # sampled nodes against the host oracle
    bad_nodes = 0
    for k in range(1, len(levels)):
        m = levels[k].shape[0]
        for i in rng.sample(range(m), min(samples, m)):
            a, b, node = (int(v) for v in FR.from_mont(torch.stack(
                [levels[k - 1][2 * i], levels[k - 1][2 * i + 1],
                 levels[k][i]])))
            bad_nodes += poseidon_hash_ref([a, b]) != node
    info["bad_nodes"] = bad_nodes
    info["root_is_top"] = bool(torch.equal(root, levels[-1][0]))
    info["root"] = str(int(FR.from_mont(root.cpu())))
    # the tree of host inserts: device-built root, proofs, tampering
    tl = torch.as_tensor(FR.to_mont(tree_leaves), device=device)
    _, troot = build_levels(tl, 16)
    info["tree_root_ok"] = (int(FR.from_mont(troot)) == tree.get_root()
                            == tree._levels()[16][0])
    info["proofs_ok"] = all(
        MerkleTree.verify_proof(tree_leaves[i], i, p, tree.get_root())
        for i, p in zip(idx, proofs))
    bad = list(proofs[1])
    bad[3] = (bad[3] + 1) % FR.modulus
    info["tamper_rejected"] = not MerkleTree.verify_proof(
        tree_leaves[idx[1]], idx[1], bad, tree.get_root())
    # warm 2^16 builds, synchronized around each
    times = []
    for s in range(3):
        x = random_mont((n,), device, seed=20 + s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build_levels(x, 16)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    info.update(build_ms=times, build_ms_best=min(times),
                bound_ms=poseidon_bound(3, n - 1, clock_hz)[0])
    if profile:
        x = random_mont((n,), device, seed=23)
        info["profile"] = profile_prove(lambda: build_levels(x, 16))
    # K7 alone at each level's width, 32,768 ... 1 hashes (CUDA events),
    # as the wrapper runs it and in each layout, beside the chain floor
    info["level_ms"], info["level_graph_ms"] = {}, {}
    info["level_floor_ms"] = {}
    for k in range(1, log2n + 1):
        x = random_mont((n >> k, 2), device, seed=40 + k)
        info["level_ms"][n >> k] = _cuda_ms(lambda: hkern.hash_tiles(x, 3),
                                            20)[0]
        info["level_graph_ms"][n >> k] = _graph_ms(
            lambda: hkern.hash_tiles(x, 3), 20)[0]
        info["level_floor_ms"][n >> k] = poseidon_floor(
            3, hkern.layout(n >> k, 3, _sms(device))[0], products,
            inverses)[1]
    info["level_layouts_ms"] = time_poseidon_layouts(
        device, 3, [n >> k for k in range(1, log2n + 1)])
    info["ok"] = (err == 0 and bad_nodes == 0 and info["root_is_top"]
                  and build_launches == log2n and info["tree_root_ok"]
                  and info["proofs_ok"] and info["tamper_rejected"])
    return info


def phase_chain(device, clock_hz, batch=1 << 15, iters=4, samples=16):
    """bench.py's Poseidon throughput: a chain of ``iters`` hash2(x, x) at
    ``batch``, warm best of 3 by the host clock, in hashes/s; sampled rows
    of the last chain against the host oracle."""
    def chain(x):
        for _ in range(iters):
            x = hkern.hash2_kernel(x, x)
        return x

    chain(random_mont((batch,), device, seed=30))
    times = []
    for s in range(1, 4):
        x = random_mont((batch,), device, seed=30 + s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = chain(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rows = random.Random(31).sample(range(batch), samples)
    ok = True
    for i in rows:
        v = int(FR.from_mont(x[i]))
        for _ in range(iters):
            v = poseidon_hash_ref([v, v])
        ok &= v == int(FR.from_mont(out[i]))
    return dict(batch=batch, iters=iters, times_s=times,
                hashes_per_s=batch * iters / min(times),
                bound_ms=poseidon_bound(3, batch * iters, clock_hz)[0],
                ok=bool(ok))


# ------------------------------------------------------- affine tree K8

def tree_bound(L, R, fl, complete, clock_hz):
    """(bound ms, bound_by) of one K8 call: per pair 6 Fp products (3 of
    batch inversion, lambda, lambda^2, lambda (xL - x3)) and one more per
    finite doubling pair (complete mode), against L, R, fl read once and the
    rows and flags written once (784 B a pair of int64 limbs). The one
    inversion per launch is left out."""
    M = L.shape[0]
    dbl = int(((L == R).all(1) & (fl == 0)).sum().item()) if complete else 0
    ops_s = (6 * M + dbl) * MADDS_PER_FP_MUL / (INT32_LANES * clock_hz)
    bytes_s = M * (3 * 32 * 8 + 2 * 8) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def tree_widths(n=1 << 14, c=13, W=20):
    """K8's pair count per level in one withdraw-scale G1 leg: W windows x
    tree_plan's bound (20 x 8,192 ... 20 x 2 for 16,384 points, c = 13)."""
    return [W * p for p in affine_tree.tree_plan(n, 1 << (c - 1))[1]]


def tree_floor(M, sms, products, inverses):
    """(product levels, floor ms) of one K8 launch of M pairs: the measured
    inverse (form iii) plus 2 log2(threads a block) product levels (the
    product tree up and down, form a), as ``tree_kernels.launch_shape``
    shapes the launch."""
    nt = tkern.launch_shape(M, sms)[0]
    levels = 2 * (nt.bit_length() - 1)
    return levels, (inverses[K8_INV_FORM]["us"]
                    + levels * products[(1, 0)]["us"]) / 1e3


def time_tree(device, clock_hz, products, inverses, pool_n=4096, seed=91):
    """K8 (complete mode, as the prover runs it) at the prover's level 0:
    its output against the plain twin's on the same inputs, the ms of both,
    the bound and the chain floor; then K8 alone at each level's width
    (CUDA events) beside its floor."""
    widths = tree_widths()
    M = widths[0]
    pool = torch.as_tensor(FP.to_mont(_points(1, pool_n, seed))) \
        .reshape(pool_n, 32).to(device)
    i = torch.arange(M, device=device)
    L = pool[i % pool_n].contiguous()
    R = pool[(7 * i + 1) % pool_n].contiguous()        # never R = L
    fl = torch.where(i % 8 == 7, 3, 0)                 # a pad slot in 8
    ms, got = _cuda_ms(lambda: tkern.tree_level(L, R, fl, True), 50)
    plain_ms, want = _cuda_ms(
        lambda: affine_tree.tree_level_plain(L, R, fl, True), 1, warm=False)
    bound_ms, bound_by = tree_bound(L, R, fl, True, clock_hz)
    sms = _sms(device)
    levels, floor_ms = tree_floor(M, sms, products, inverses)
    res = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               shape=M, launch_shape=tkern.launch_shape(M, sms),
               chain_levels=levels, floor_ms=floor_ms,
               max_abs_err=max(int((g - w).abs().max().item())
                               for g, w in zip(got, want)))
    level = lambda m: (lambda: tkern.tree_level(L[:m], R[:m], fl[:m], True))
    res["level_ms"] = {m: _cuda_ms(level(m), 20)[0] for m in widths}
    res["level_graph_ms"] = {m: _graph_ms(level(m), 20)[0] for m in widths}
    res["level_bound_ms"] = {m: tree_bound(L[:m], R[:m], fl[:m], True,
                                           clock_hz)[0] for m in widths}
    res["level_floor_ms"] = {m: tree_floor(m, sms, products, inverses)[1]
                             for m in widths}
    return res


def phase_tree(device, g1, ctx, profile=False):
    """``tree=True``: the 2^18 G1 MSM of phase 3 and a 2^14 MSM with
    all-equal scalars against the native oracle, then proofs of phase 4's
    circuit with DeviceProvingKey(pk, tree=True): verified, a tampered
    input rejected, seed 7 equal to phase 4's proof; K8's launches;
    ``profile`` traces one warm tree proof."""
    info = {}
    msm = lambda: grid.msm_grid_g1(g1["pts_dev"], g1["limbs"], tree=True)
    cold_ms, _ = _host_ms(msm)
    warm_ms, res = _host_ms(msm)
    info["msm18"] = dict(cold_ms=cold_ms, warm_ms=warm_ms, ok=tp._g1_affine(
        tuple(t.cpu() for t in res)) == g1["want"])
    if profile:
        # one warm 2^18 tree MSM: K8's device ms against the rest (the
        # other kernels, and torch glue: affine_tree.bucket_sums_tree's
        # gathers, selects and counts, and the grid pipeline around it)
        p = profile_prove(msm)
        k8 = p["by_kernel"].get("k_tree_level", {}).get("device_ms", 0.0)
        ours = sum(v["device_ms"] for v in p["by_kernel"].values())
        info["msm18"]["split"] = dict(
            wall_ms=p["wall_s"] * 1e3, device_ms=p["device_busy_s"] * 1e3,
            k8_ms=k8, other_kernels_ms=ours - k8,
            glue_device_ms=p["device_busy_s"] * 1e3 - ours,
            by_kernel=p["by_kernel"], top=p["top"])
    n = 1 << 14
    k = random.Random(18).randrange(1, FR_MOD)
    pts_dev = tuple(t[:n].contiguous() for t in g1["pts_dev"])
    limbs = torch.as_tensor(ints_to_limbs([k] * n), device=device)
    warm_ms, res = _host_ms(lambda: grid.msm_grid_g1(pts_dev, limbs, tree=True))
    live = [p for p in g1["pts"][:n] if p is not None]
    info["msm14_equal"] = dict(warm_ms=warm_ms, ok=tp._g1_affine(
        tuple(t.cpu() for t in res)) == native_bridge.g1_msm([k] * len(live),
                                                             live))

    r1cs, w, vk = ctx["r1cs"], ctx["w"], ctx["vk"]
    pub = w[1:r1cs.num_public]
    dpk = tp.DeviceProvingKey(ctx["pk"], tree=True, device=device)
    tkern.reset_launches()            # the tree path starts here
    t0 = time.perf_counter()
    proof = tp.prove(dpk, r1cs, w, seed=7)
    info["cold_s"] = time.perf_counter() - t0
    ok = verify(vk, proof, pub)
    ok &= not verify(vk, proof, [pub[0] + 1] + pub[1:])
    warm = []
    for i in range(3):
        t0 = time.perf_counter()
        p = tp.prove(dpk, r1cs, w, seed=8 + i)
        warm.append(time.perf_counter() - t0)
        ok &= verify(vk, p, pub)
    launches = tkern.LAUNCHES["tree_level"]   # the tree path ends here
    phases = {}
    tp.prove(dpk, r1cs, w, seed=11, timings=phases)
    if profile:
        info["profile"] = profile_prove(lambda: tp.prove(dpk, r1cs, w,
                                                         seed=12))
    info.update(verified=bool(ok), equals_prefix=proof == ctx["proof"],
                warm_s=warm, proofs_per_s=len(warm) / sum(warm),
                phases_s=phases, launches=launches,
                launches_per_proof=launches / 4)
    info["ok"] = (info["msm18"]["ok"] and info["msm14_equal"]["ok"]
                  and info["verified"] and info["equals_prefix"])
    return info


# ------------------------------------- the batched verify: P1 and P2

# The least Fp products of each step of the pairing (the bound counts
# these, not the kernels' own forms where they take more): the Miller
# loop's Fp12 square (the complex method over Fp6: two Karatsuba Fp6
# products, 36) and a line (l1 = alpha_neg px, 2, then the product by
# (l0 + 0 v + 0 v^2) + (l1 + l3 v) w, l0 in Fp, by Karatsuba over Fp6:
# g l0 takes 6, h (l1, l3) and (g + h)(l0 + l1, l3) are each a product by
# a sparse Fp6 of 5 Fp2 products, 36 in all; the kernel takes 48); the
# final exponentiation's Fp12 product (Karatsuba over Fp6, 54),
# Granger-Scott cyclotomic square (18), Frobenius by its power (gamma_0 =
# 1, the p^2 gammas in Fp: 15, 10, 15; the kernel takes 18) and inverse
# (a conj(a) = g^2 - h^2 v as two Fp6 squares of 12, the closed-form Fp6
# inverse's 37 and conj(a) times an Fp6 value, two Fp6 products; its
# safegcd inverse is not counted).
PAIR_PRODUCTS = dict(sqr=36, line=2 + 36, mul=54, cyclo=18,
                     frob={1: 15, 2: 10, 3: 15},
                     inv=2 * 12 + 3 * 2 + 3 * 3 + 3 * 3 + 2 + 2 + 3 * 3
                     + 2 * 18)
# dependent product levels of the inverse before and after its safegcd
INV_LEVELS = 7
FE_COST = {0: "mul", 1: "cyclo", 2: "frob"}     # FE_PROGRAM op kinds


def miller_lines_count(legs):
    """Line evaluations of one Miller loop over ``legs`` legs."""
    bits = plines.ATE_BITS
    return (len(bits) + sum(bits) + 2) * legs


def miller_products(legs):
    return (len(plines.ATE_BITS) * PAIR_PRODUCTS["sqr"]
            + miller_lines_count(legs) * PAIR_PRODUCTS["line"])


def fe_products():
    return PAIR_PRODUCTS["inv"] + sum(
        PAIR_PRODUCTS["frob"][b] if k == 2 else PAIR_PRODUCTS[FE_COST[k]]
        for k, _, b, _ in pairing.FE_PROGRAM.tolist() if k in FE_COST)


def pairing_levels(name, legs=3):
    """Dependent product levels on one batch element's longest chain: P1
    one a square and one a line (a line's products hang off f and its own
    l1, which does not wait on f), plus the first l1; P2 the inverse's
    levels, then the critical path of FE_PROGRAM's dependency graph, one
    level a product, square or Frobenius."""
    if name == "miller_lines":
        return len(plines.ATE_BITS) + miller_lines_count(legs) + 1
    lv = [0] * pairing.FE_NREG
    lv[1] = INV_LEVELS
    for kind, a, b, dst in pairing.FE_PROGRAM.tolist():
        lvl = max(lv[a], lv[b]) if kind == 0 else lv[a]
        lv[dst] = lvl + (kind in FE_COST)
    return lv[pairing.FE_OUT]


def pairing_bound(name, B, nbytes, clock_hz, legs=3):
    muls = B * (miller_products(legs) if name == "miller_lines"
                else fe_products())
    return _bound_of(muls, nbytes, clock_hz)


def pairing_floor(name, products, inverses, legs=3):
    """(levels, floor ms): the dependent product levels times the product
    microbenchmark's form (a) time (one thread, out of line, Fp), plus for
    P2 one safegcd inversion (the inverse microbenchmark's step)."""
    levels = pairing_levels(name, legs)
    us = levels * products[(1, 0)]["us"]
    if name == "final_exp":
        us += inverses[K8_INV_FORM]["us"]
    return levels, us / 1e3


def pairing_inputs(device, legs, B, batched, seed):
    """Seeded canonical limbs as a Miller loop's inputs: per leg a G1 point
    (px, py) int64[B, 16] and ``LineArrays``, [S, B, 16] where
    ``batched[i]`` and [S, 16] (a fixed leg) elsewhere."""
    g1s, lgs = [], []
    for i in range(legs):
        s = seed + 20 * i
        g1s.append((random_mont((B,), device, s),
                    random_mont((B,), device, s + 1)))
        lgs.append(plines.LineArrays(*[
            random_mont(((plines.N_STEPS if k < 8 else 2),)
                        + ((B,) if batched[i] else ()), device, s + 2 + k)
            for k in range(12)]))
    return g1s, lgs


def _pairing_prefix(g1s, legs, b):
    """The first b batch elements of a Miller loop's inputs."""
    return ([(x[:b], y[:b]) for x, y in g1s],
            [plines.LineArrays(*[t[:, :b].contiguous() if t.dim() == 3
                                 else t for t in lg]) for lg in legs])


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts)


PAIR_BS = (1, 3, 4, 33)   # 1, 3 and 33 leave the last block partial


def time_programs(device):
    """Seconds of the lane programs' first use in this process: their
    compile (``pairing_program.program``) and the blob's upload
    (``pairing_kernels._blob``); None where an earlier call made them."""
    if device in pkern._blobs or pairing_program.program.cache_info().currsize:
        return None
    t0 = time.perf_counter()
    pairing_program.program()
    t1 = time.perf_counter()
    pkern._blob(device)
    torch.cuda.synchronize(device)
    return dict(compile_s=t1 - t0, upload_s=time.perf_counter() - t1)


def check_pairing(device, B=256, Bs=PAIR_BS, seed=300):
    """P1 and P2 against their plain versions on the card, limb for limb.
    P1 with 3 legs (one batched, two fixed at batch stride 0) at B and at
    each b of ``Bs`` on the same inputs' first b rows, and with 2 batched
    legs (the PoK shape) at each b; P2 on P1's outputs (at B and each b, and
    the 2-leg ones), and on random Fp12 values with 1 and 0 planted.
    Returns ({(name, variant): max |kernel - plain|}, {name: the plain
    version's ms at B (host clock)}, P1's 3-leg inputs)."""
    errs, plain_ms = {}, {}

    def held(key, got, want):
        errs[key] = int((got - want).abs().max().item())

    g3, l3 = pairing_inputs(device, 3, B, (True, False, False), seed)
    plain_ms["miller_lines"], want3 = _host_ms(
        lambda: pairing.miller_loop_lines_plain(g3, l3))
    got3 = pkern.miller_lines(g3, l3)
    held(("miller_lines", f"3 legs B={B}"), got3, want3)
    b2 = max(Bs)
    g2, l2 = pairing_inputs(device, 2, b2, (True, True), seed + 100)
    want2 = pairing.miller_loop_lines_plain(g2, l2)
    for b in Bs:
        held(("miller_lines", f"3 legs B={b}"),
             pkern.miller_lines(*_pairing_prefix(g3, l3, b)), want3[:b])
        held(("miller_lines", f"2 legs B={b}"),
             pkern.miller_lines(*_pairing_prefix(g2, l2, b)), want2[:b])
    plain_ms["final_exp"], fe3 = _host_ms(
        lambda: pairing.final_exponentiation_plain(got3))
    held(("final_exp", f"P1 3 legs B={B}"), pkern.final_exp(got3), fe3)
    for b in Bs:
        held(("final_exp", f"P1 3 legs B={b}"),
             pkern.final_exp(got3[:b].contiguous()), fe3[:b])
    got2 = pkern.miller_lines(g2, l2)
    rnd = random_mont((b2, 12), device, seed + 200)
    rnd[0] = tower.f12_one((), device)
    rnd[1] = 0
    # the plain version is element by element: one call for both batches
    fe2 = pairing.final_exponentiation_plain(torch.cat([got2, rnd]))
    held(("final_exp", f"P1 2 legs B={b2}"), pkern.final_exp(got2),
         fe2[:b2])
    held(("final_exp", f"random, 1 and 0, B={b2}"), pkern.final_exp(rnd),
         fe2[b2:])
    return errs, plain_ms, (g3, l3)


def time_pairing(device, clock_hz, products, inverses, g3, l3, plain_ms,
                 reps=5):
    """P1 (3 legs, the verify's shape) and P2 on its output at B by CUDA
    events, beside the plain version's ms, the bound and the chain floor."""
    B = g3[0][0].shape[0]
    rows = {}
    ms, f = _cuda_ms(lambda: pkern.miller_lines(g3, l3), reps)
    ins = [t for p in g3 for t in p] + [t for lg in l3 for t in lg]
    bound, by = pairing_bound("miller_lines", B,
                              _nbytes(ins) + f.numel() * 8, clock_hz)
    levels, floor = pairing_floor("miller_lines", products, inverses)
    rows["miller_lines"] = dict(
        shape=f"B={B}, 3 legs (2 fixed)", ms=ms,
        plain_ms=plain_ms["miller_lines"], bound_ms=bound, bound_by=by,
        floor_ms=floor, chain_levels=levels, fp_products=miller_products(3),
        max_abs_err=0)
    ms, _ = _cuda_ms(lambda: pkern.final_exp(f), reps)
    bound, by = pairing_bound("final_exp", B, 2 * f.numel() * 8, clock_hz)
    levels, floor = pairing_floor("final_exp", products, inverses)
    rows["final_exp"] = dict(
        shape=f"B={B}", ms=ms, plain_ms=plain_ms["final_exp"],
        bound_ms=bound, bound_by=by, floor_ms=floor, chain_levels=levels,
        fp_products=fe_products(), max_abs_err=0)
    return rows


def committed_circuit():
    """The small circuit with a gnark-style Pedersen commitment of the
    port's committed-prover test: out = x^3 + x + 5 and u = t x, t the
    commitment-hash public input (the last). Returns (r1cs, pk, vk,
    witness fn(x) -> (w, cm, pok))."""
    r1cs = R1CS(num_vars=7, num_public=3,
                a_rows=[{3: 1}, {4: 1}, {}, {2: 1}],
                b_rows=[{3: 1}, {3: 1}, {0: 1}, {3: 1}],
                c_rows=[{4: 1}, {5: 1},
                        {1: 1, 5: -1 % FR_MOD, 3: -1 % FR_MOD,
                         0: -5 % FR_MOD}, {6: 1}])
    pk, vk = setup(r1cs, committed=(3,))

    def witness(x):
        cm, pok = pedersen.commit(list(pk.basis), list(pk.basis_exp_sigma),
                                  [x])
        t = pedersen.commitment_to_field(cm)
        w = [1, (x ** 3 + x + 5) % FR_MOD, t, x, x * x % FR_MOD,
             x ** 3 % FR_MOD, t * x % FR_MOD]
        assert r1cs.is_satisfied(w)
        return w, cm, pok

    return r1cs, pk, vk, witness


def _ref_verify(vk, proof, pub):
    """refimpl verify, with a zero denominator (a pow of 0 to -1 in its
    Miller loop) read as a rejection."""
    try:
        return verify(vk, proof, pub)
    except ValueError:
        return False


def phase_verify(device, ctx, n_distinct=32, tile=8):
    """The batched Groth16 verify on the card (``groth16.verify``): 32
    distinct proofs of phase 4's key from ``prove_batch``, tiled to 256,
    verified cold and three times warm (host split of each: the VK
    precompute, L_pub, the B-line walk, its packing, the G1 uploads; the
    device part);
    a second batch with a corrupted public input, a swapped C, a foreign A
    and a B of zero y planted at known positions, which must be exactly the
    rejected ones, its 32 distinct proofs against refimpl's verify; a
    committed batch (PoK pairing) with one tampered PoK. The pairing
    kernels' launches are counted over this phase."""
    r1cs, vk, dpk = ctx["r1cs"], ctx["vk"], ctx["dpk"]
    npub = r1cs.num_public
    t0 = time.perf_counter()
    ws = [ctx["witness"](100 + i) for i in range(n_distinct)]
    proofs = tp.prove_batch(dpk, r1cs, ws, seed=500)
    info = dict(prove_batch_s=time.perf_counter() - t0)
    pubs = [w[1:npub] for w in ws]
    batch, bpubs = proofs * tile, pubs * tile
    n = len(batch)
    pkern.reset_launches()            # the main path starts here
    cold_sp = {}
    t0 = time.perf_counter()
    ok_cold = tverify.verify_batch(vk, batch, bpubs, device=device,
                                   timings=cold_sp)
    info.update(cold_s=time.perf_counter() - t0, cold_split_s=cold_sp)
    warm, splits = [], []
    for _ in range(3):
        sp = {}
        t0 = time.perf_counter()
        ok = tverify.verify_batch(vk, batch, bpubs, device=device,
                                  timings=sp)
        warm.append(time.perf_counter() - t0)
        splits.append(sp)
        ok_cold &= ok
    info.update(batch=n, warm_s=warm, proofs_per_s=n / min(warm),
                cold_proofs_per_s=n / info["cold_s"], split_s=splits,
                all_valid=bool(ok_cold.all()))
    # planted faults
    bad = dict(batch=list(batch), pubs=[list(p) for p in bpubs])
    i_pub, i_c, i_b, i_a = 3, n * 3 // 10, n // 2 + 1, n * 25 // 32
    plant = {i_pub: "public input + 1", i_c: "C of another proof",
             i_b: "B with y = 0", i_a: "A of another proof"}
    bad["pubs"][i_pub][0] += 1
    A, B2, C = batch[i_c]
    bad["batch"][i_c] = (A, B2, batch[i_c + 1][2])
    A, B2, C = batch[i_b]
    bad["batch"][i_b] = (A, (B2[0], (0, 0)), C)
    A, B2, C = batch[i_a]
    bad["batch"][i_a] = (batch[i_a + 1][0], B2, C)
    got = tverify.verify_batch(vk, bad["batch"], bad["pubs"], device=device)
    rejected = [i for i in range(n) if not got[i]]
    ref = [_ref_verify(vk, p, x) for p, x in
           zip(bad["batch"][:n_distinct], bad["pubs"][:n_distinct])]
    info.update(planted=plant, rejected=rejected,
                ref_agrees=bool(list(got[:n_distinct]) == ref))
    # a committed batch: the PoK pairing
    cr1cs, cpk, cvk, cwit = committed_circuit()
    cws = [cwit(x) for x in (3, 4, 5, 6)]
    cdpk = tp.DeviceProvingKey(cpk, c=8, lanes=32, device=device)
    cproofs = tp.prove_batch(cdpk, cr1cs, [w for w, _, _ in cws], seed=11)
    cpubs = [[w[1]] for w, _, _ in cws]
    A, B2, C, cm, pok = cproofs[2]
    tampered = list(cproofs)
    tampered[2] = (A, B2, C, cm, pr.g1_add(pok, (1, 2)))
    cgot = tverify.verify_batch(cvk, cproofs, cpubs, device=device)
    tgot = tverify.verify_batch(cvk, tampered, cpubs, device=device)
    cref = [_ref_verify(cvk, p, x) for p, x in zip(tampered, cpubs)]
    launches = dict(pkern.LAUNCHES)   # the main path ends here
    info.update(committed=dict(valid=cgot.tolist(), tampered=tgot.tolist(),
                               ref=cref), launches=launches)
    info["ok"] = bool(
        info["all_valid"] and rejected == sorted(plant) and info["ref_agrees"]
        and cgot.all() and tgot.tolist() == [True, True, False, True]
        and cref == tgot.tolist())
    return info


# ---------------------------------------- the audit path: P3 and phase 11

# Owner 0 of the audit batch: the withdraw vectors' key and point
# (tests/vectors.py), sk * G on the embedded curve.
SECRET_KEY = 0x43F5147FE5A665DF7600DA3AE1C0AE1C
OWNER_X = 0x13C1A5D58F3CE2659C8CB9F6686264197864954B53A3BA1EDA4168B9B18927B8
OWNER_Y = 0x1D1E2A6A28D810BC04992F6E8F890F1D9CAD471819BC111AE229B507F4D77A0F
AUDIT_FIELDS = audit_circuit.PACKED_C0 + audit_circuit.PACKED_C1   # 157
AUDIT_ROWS = 24070             # const_pk_e_witness, logderiv
P3_BS = (1, 2, 33, 256, 4096)  # P3's batches held to the plain version
P3_NS = (0, 1, 2, 3, 4, AUDIT_FIELDS)   # sponge lengths held
P3_TIMED_BS = (1, 256, 4096)
P3_ROW = max(P3_BS)            # the kernels line's P3 row: the largest batch
# the committed audit proofs (each ~17-30 s of host Python; cut for the
# run's time limit from 4 to 2, then to 1: a cold proof alone)
AUDIT_PROOFS = 1
# One permutation: 88 S-boxes (4 a full round, 1 a partial round) of two
# squares and a product, and 4 diagonal products a partial round: 176
# squares and 312 products, 488 in all. Its least chain is 3 dependent
# product levels a round, full or partial (x^2, x^4, x^5; a partial round's
# d_0 x^5 = x^4 (d_0 x) shares the third): 192.
P2_SBOXES = poseidon2.R_F * poseidon2.T + poseidon2.R_P
P2_PRODUCTS = 3 * P2_SBOXES + poseidon2.R_P * poseidon2.T
P2_LEVELS = 3 * (poseidon2.R_F + poseidon2.R_P)
# the product form P3 runs: each product on 4 lanes (form g)
P3_FORM = 7


def p2_perms(n):
    """Permutations of a sponge over n fields: one a block of 3, one for
    the remainder (possibly empty)."""
    return n // 3 + 1


def p2_madds():
    """32-bit multiply-adds of one permutation in its least form: each
    S-box two dedicated squares and a product, each diagonal term one
    product; the M4 and sum additions are not counted."""
    sbox = 2 * (MADDS_WIDE_SQR + MADDS_REDC) + MADDS_WIDE + MADDS_REDC
    return P2_SBOXES * sbox + poseidon2.R_P * poseidon2.T * MADDS_PER_FP_MUL


def p3_bound(B, n, clock_hz, sponge=True):
    """(bound ms, bound_by) of P3 on B states (form a) or B sponges over n
    fields (form b): multiply-adds over the INT32 rate against the int64
    limbs read once and written once over the memory rate."""
    perms = p2_perms(n) if sponge else 1
    ops_s = B * perms * p2_madds() / (INT32_LANES * clock_hz)
    rows = n + 1 if sponge else 2 * poseidon2.T
    bytes_s = B * rows * 16 * 8 / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def p3_floor(n, products, sponge=True):
    """(product levels, floor ms) of one state's chain: P2_LEVELS a
    permutation at the time of a dependent product in the form P3 runs
    (form g, a product on 4 lanes)."""
    levels = P2_LEVELS * (p2_perms(n) if sponge else 1)
    return levels, levels * products[(1, P3_FORM)]["us"] / 1e3


def check_poseidon2(device, Bs=P3_BS, ns=P3_NS, seed=400, keep=None):
    """P3 against its plain version limb for limb: the permutation at each
    B and the sponge at each (B, n), on random values with 0, 1 and r - 1
    planted alone and mixed in the first rows (each batch a prefix of the
    largest, so the plain version runs once a form and n); Barretenberg's
    permutation(0, 1, 2, 3). Returns ({(form, B, n): max |err|}, plain ms of
    the largest batch's permutation). ``keep``, if a dict, receives the
    largest n's sponge for ``time_poseidon2``: its inputs, the plain
    version's output, its ms by the host clock and its FieldCtx calls."""
    errs, big = {}, max(Bs)
    x = poseidon_special(poseidon2.T + 1, big, device, seed)
    perm_ms, want = _host_ms(lambda: poseidon2.permutation_plain(x))
    for B in Bs:
        errs[("poseidon2", "permutation", (B, poseidon2.T))] = _max_err(
            p2k.permute(x[:B].contiguous()), want[:B])
    for n in ns:
        x = poseidon_special(n + 1, big, device, seed + n).reshape(
            big, n, 16)
        if n == max(ns):
            (ms, want), calls = count_fieldctx(lambda: _host_ms(
                lambda: poseidon2.ct_commitment_plain(x)))
            if keep is not None:
                keep.update(x=x, want=want, plain_ms=ms, calls=calls)
        else:
            want = poseidon2.ct_commitment_plain(x)
        for B in Bs:
            errs[("poseidon2", "sponge", (B, n))] = _max_err(
                p2k.sponge(x[:B].contiguous()), want[:B])
    bb = torch.as_tensor(FR.to_mont([[0, 1, 2, 3]]), device=device)
    got = [int(v) for v in FR.from_mont(p2k.permute(bb))[0]]
    errs[("poseidon2", "bb vector", (1, poseidon2.T))] = int(
        got != poseidon2.permutation_ref([0, 1, 2, 3]))
    return errs, perm_ms


def count_fieldctx(fn):
    """(output, FieldCtx public calls made by ``fn``) through FR."""
    calls = [0]
    names = ("add", "sub", "mont_mul")
    saved = {k: getattr(FR, k) for k in names}

    def counted(f):
        def g(*a, **k):
            calls[0] += 1
            return f(*a, **k)
        return g

    for k in names:
        setattr(FR, k, counted(saved[k]))
    try:
        out = fn()
    finally:
        for k in names:
            setattr(FR, k, saved[k])
    return out, calls[0]


def device_launches(fn):
    """(output, kernel launches of one call of ``fn``, its copy and fill
    calls by name): ``profiling.kernel_launches``, the one count of every
    launch figure here, which counts the host's launch calls."""
    out, launches, _, copies = kernel_launches(fn)
    return out, sum(launches.values()), copies


def time_poseidon2(device, clock_hz, products, sponge, Bs=P3_TIMED_BS,
                   reps=5):
    """The need for P3, then P3 alone, on ``check_poseidon2``'s largest
    sponge (B states of n fields): the plain sponge's ms on the card (host
    clock, synchronized, from the check's one call) and its
    FieldCtx calls, the device launches of one plain permutation (the
    profiler); P3's sponge at each of Bs and its permutation at 256 states
    by CUDA events, beside the bound and the chain floor."""
    x = sponge["x"]
    B, n = x.shape[:2]
    _, perm_launches, _ = device_launches(
        lambda: poseidon2.permutation_plain(x[:256, :4]))
    rows = {}
    for b in Bs:
        xb = x[:b].contiguous()
        ms, got = _cuda_ms(lambda: p2k.sponge(xb), reps)
        bound, by = p3_bound(b, n, clock_hz)
        levels, floor = p3_floor(n, products)
        rows[b] = dict(shape=f"B={b}, n={n}", ms=ms, bound_ms=bound,
                       bound_by=by, floor_ms=floor, chain_levels=levels,
                       products=b * p2_perms(n) * P2_PRODUCTS)
        if b == B:
            rows[b].update(plain_ms=sponge["plain_ms"],
                           max_abs_err=_max_err(got, sponge["want"]),
                           plain_fieldctx_calls=sponge["calls"],
                           plain_permutation_launches=perm_launches)
    xs = x[:256, :4].contiguous()
    ms, _ = _cuda_ms(lambda: p2k.permute(xs), reps)
    bound, by = p3_bound(256, 0, clock_hz, sponge=False)
    levels, floor = p3_floor(0, products, sponge=False)
    rows["permutation"] = dict(shape="B=256, one permutation", ms=ms,
                               bound_ms=bound, bound_by=by, floor_ms=floor,
                               chain_levels=levels)
    return dict(rows[B], by_batch=rows)


def _noise(i):
    """The signed noise of ``rlwe_ref.encrypt(seed=999 + i)``, drawn in its
    order: r (N), e1 (MSG_SLOTS), e2 (N)."""
    rng = random.Random(999 + i)
    nb = rlwe_ref.NOISE_BOUND
    r = [rng.randint(-nb, nb) for _ in range(rlwe_ref.N)]
    e1 = [rng.randint(-nb, nb) for _ in range(rlwe_ref.MSG_SLOTS)]
    e2 = [rng.randint(-nb, nb) for _ in range(rlwe_ref.N)]
    return r, e1, e2


def _q_dev(vals, device):
    """Signed or mod-q ints (any nesting) -> int32 words < q on device."""
    a = np.remainder(np.asarray(vals, dtype=np.int64), rlwe_ref.RLWE_Q)
    return rlweq.from_numpy_u32(a.astype(np.uint32), device)


def _timed_step(steps, name, fn):
    """``fn`` twice by the host clock, synchronized: steps[name] = [cold
    ms, warm ms]; the warm call's output."""
    cold, _ = _host_ms(fn)
    warm, out = _host_ms(fn)
    steps[name] = [cold, warm]
    return out


def phase_audit(device, B=256, seed=501, oracles=(0, 1, 2, 255),
                keep=None):
    """The audit path on the card (phase 11): RLWE keygen from
    ``rlwe_ref.keygen(42)``'s randomness, Shamir shares and every pair's
    reconstruction; B identities encrypted with their quotient witnesses,
    held to the oracle, to k q + rem = full in int64 numpy, decrypted, and
    committed through P3 against ``ct_commitment_ref``; the committed
    24,070-row audit circuit built, set up, solved, proved (one cold and
    AUDIT_PROOFS - 1 warm proofs) and verified through P1 and P2, ct + 1 and
    a tampered proof of knowledge rejected; the auditor's decrypt from
    shares 1 and 2 and the K7 hash of the recovered point. The launches of
    K1-K7, P1, P2 and P3 are counted from the encryption to the end.
    ``keep``, if a dict, receives the VK and the audit proofs with
    their public inputs."""
    Q, N, MS = rlwe_ref.RLWE_Q, rlwe_ref.N, rlwe_ref.MSG_SLOTS
    info, steps, checks = {}, {}, {}
    # 3. keygen and Shamir
    t0 = time.perf_counter()
    kg = rlwe_ref.keygen(42)
    steps["keygen_oracle_s"] = time.perf_counter() - t0
    sk_q, a_q, e_q = (_q_dev(kg[k], device)
                      for k in ("sk_signed", "a", "e_signed"))
    b_dev = _timed_step(steps, "keygen_ms", lambda: renc.keygen_from_randomness(
        sk_q, a_q, e_q))
    checks["keygen_b"] = b_dev.tolist() == kg["b"]
    sks = [v % FR_MOD for v in kg["sk_signed"]]
    coeff = [(y - s) % FR_MOD for (_, y), s in zip(kg["shares"][0], sks)]
    secrets = torch.as_tensor(FR.to_mont(sks), device=device)
    co = torch.as_tensor(FR.to_mont([coeff]), device=device)
    shares = _timed_step(steps, "share_ms", lambda: share_batch(secrets, co))
    checks["shares"] = all(
        FR.from_mont(shares[k]).tolist() == [y for _, y in kg["shares"][k]]
        for k in range(3))
    checks["reconstruct"] = all(
        FR.from_mont(reconstruct_batch(shares[[x - 1 for x in xs]], xs))
        .tolist() == sks for xs in ((1, 2), (1, 3), (2, 3)))
    # 4. encrypt B identities: the counts start here
    for reset in (kernels.reset_launches, hkern.reset_launches,
                  pkern.reset_launches, p2k.reset_launches):
        reset()
    rng = random.Random(seed)
    t0 = time.perf_counter()
    keys = [SECRET_KEY] + [rng.getrandbits(128) for _ in range(B - 1)]
    owners = [curve_ref.scalar_mul(k) for k in keys]
    noise = [_noise(i) for i in range(B)]
    msgs = np.stack([renc.encode_message(x, y) for x, y in owners])
    steps["owners_noise_s"] = time.perf_counter() - t0
    checks["owner0"] = owners[0] == (OWNER_X, OWNER_Y)
    r_s = np.asarray([n[0] for n in noise], dtype=np.int64)
    e1_s = np.asarray([n[1] for n in noise], dtype=np.int64)
    e2_s = np.asarray([n[2] for n in noise], dtype=np.int64)
    ins = [_q_dev(v, device) for v in (r_s, e1_s, e2_s,
                                       msgs.astype(np.int64) * rlwe_ref.DELTA)]
    c0, c1 = _timed_step(steps, "encrypt_ms", lambda: renc.encrypt_core(
        a_q, b_dev, *ins))
    r_dev = torch.as_tensor(r_s, device=device)
    extra0 = np.zeros((B, N), np.int64)
    extra0[:, :MS] = e1_s + rlwe_ref.DELTA * msgs.astype(np.int64)
    k1, rem1 = _timed_step(steps, "quotient_c1_ms",
                           lambda: quotient.quotient_witnesses(
                               kg["a"], r_dev, torch.as_tensor(e2_s,
                                                               device=device)))
    k0, rem0 = _timed_step(steps, "quotient_c0_ms",
                           lambda: quotient.quotient_witnesses(
                               kg["b"], r_dev, torch.as_tensor(extra0,
                                                               device=device)))
    c0h, c1h = c0.cpu().numpy().astype(np.int64), c1.cpu().numpy().astype(
        np.int64)
    k0h, k1h = k0.cpu().numpy(), k1.cpu().numpy()
    t0 = time.perf_counter()
    ok_oracle = True
    for i in oracles:
        ref = rlwe_ref.encrypt(kg["a"], kg["b"], *owners[i], seed=999 + i)
        ok_oracle &= (c0h[i].tolist() == ref["c0_sparse"]
                      and c1h[i].tolist() == ref["c1"]
                      and k0h[i, :MS].tolist() == ref["k0"]
                      and k1h[i].tolist() == ref["k1"])
    steps["encrypt_oracles_s"] = time.perf_counter() - t0
    checks["oracle_encryptions"] = bool(ok_oracle)
    # full = <row k, r> + extra in int64 numpy, the rows rlwe_ref's
    t0 = time.perf_counter()
    ok_quot = True
    for pk_, kh, remh, ch, extra, m in (
            (kg["a"], k1h, rem1.cpu().numpy(), c1h, e2_s, N),
            (kg["b"], k0h, rem0.cpu().numpy(), c0h, extra0, MS)):
        mat = np.array([rlwe_ref.negacyclic_matrix_row(pk_, k)
                        for k in range(N)], dtype=np.int64)
        full = r_s @ mat.T + extra
        ok_quot &= bool((kh * Q + remh == full).all()
                        and (remh[:, :m] == ch).all()
                        and ((remh >= 0) & (remh < Q)).all())
    steps["quotient_check_s"] = time.perf_counter() - t0
    checks["quotients"] = ok_quot
    msg_dev = _timed_step(steps, "decrypt_ms",
                          lambda: renc.decrypt_core(sk_q, c0, c1))
    checks["decrypt_all"] = bool((msg_dev.cpu().numpy() == msgs).all())
    t0 = time.perf_counter()
    packed = [rlwe_ref.pack_values(c0h[i].tolist())
              + rlwe_ref.pack_values(c1h[i].tolist()) for i in range(B)]
    packed_dev = torch.as_tensor(FR.to_mont(packed), device=device)
    steps["pack_upload_s"] = time.perf_counter() - t0
    ct_dev = _timed_step(steps, "ct_commitment_ms",
                         lambda: poseidon2.ct_commitment(packed_dev))
    t0 = time.perf_counter()
    cts = [int(v) for v in FR.from_mont(ct_dev)]
    checks["ct_commitments"] = cts == [
        poseidon2.ct_commitment_ref(p) for p in packed]
    steps["ct_oracle_s"] = time.perf_counter() - t0
    # 5. the audit proof of owner 0
    t0 = time.perf_counter()
    circ = audit_circuit.build_audit_circuit(
        kg["a"], kg["b"], "const_pk_e_witness", logderiv=True)
    r1cs = circ.builder.r1cs()
    steps["build_s"] = time.perf_counter() - t0
    checks["rows"] = len(r1cs.a_rows) == AUDIT_ROWS
    t0 = time.perf_counter()
    pk, vk = setup(r1cs, committed=circ.committed)
    steps["setup_s"] = time.perf_counter() - t0
    enc0 = dict(c0_sparse=c0h[0].tolist(), c1=c1h[0].tolist(),
                r_signed=r_s[0].tolist(), e1_signed=e1_s[0].tolist(),
                e2_signed=e2_s[0].tolist(), k0=k0h[0, :MS].tolist(),
                k1=k1h[0].tolist())
    wa, ct = poseidon_hash_ref([OWNER_X, OWNER_Y]), cts[0]
    t0 = time.perf_counter()
    w = circ.builder.witness_committed(
        circ.assignment(OWNER_X, OWNER_Y, enc0, wa, ct, SECRET_KEY),
        circ.v_challenge, pk)
    steps["witness_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks["satisfied"] = r1cs.is_satisfied(w)
    steps["is_satisfied_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dpk = tp.DeviceProvingKey(pk, device=device)
    torch.cuda.synchronize()
    steps["upload_s"] = time.perf_counter() - t0
    proofs, prove_s, phases = [], [], []
    for i in range(AUDIT_PROOFS):  # one cold, the rest warm
        sp = {}
        t0 = time.perf_counter()
        proofs.append(tp.prove(dpk, r1cs, w, seed=70 + i, timings=sp))
        prove_s.append(time.perf_counter() - t0)
        phases.append(sp)
    A, B2, C, cm, pok = proofs[-1]
    tampered = (A, B2, C, cm, pr.g1_add(pok, (1, 2)))
    pubs = [[wa, ct]] * AUDIT_PROOFS + [[wa, ct + 1], [wa, ct]]
    t0 = time.perf_counter()
    got = tverify.verify_batch(vk, proofs + [proofs[0], tampered], pubs,
                               device=device)
    steps["verify_s"] = time.perf_counter() - t0
    checks["verify"] = got.tolist() == [True] * AUDIT_PROOFS + [False, False]
    if keep is not None:           # the committed proofs, for phase 12
        keep.update(vk=vk, proofs=[(p, [wa, ct]) for p in proofs])
    # 6. the auditor's decrypt from shares 1 and 2
    t0 = time.perf_counter()
    rec = reconstruct_batch(shares[[0, 1]], (1, 2))
    sk_aud = renc.centered_mod_q(rec)
    m0 = renc.decrypt_core(sk_aud, c0[:1], c1[:1])
    xy = renc.decode_message(m0[0])
    h = poseidon.hash2(*(torch.as_tensor(FR.to_mont([v]), device=device)
                         for v in xy))
    wa_dev = int(FR.from_mont(h)[0])
    steps["auditor_ms"] = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.LAUNCHES, poseidon=hkern.LAUNCHES["poseidon"],
                    **pkern.LAUNCHES, poseidon2=p2k.LAUNCHES["poseidon2"])
    checks["auditor_key"] = torch.equal(sk_aud, sk_q)
    checks["auditor_point"] = xy == (OWNER_X, OWNER_Y)
    checks["auditor_wa"] = wa_dev == wa == w[circ.v_wa]
    info.update(batch=B, rows=len(r1cs.a_rows), wires=r1cs.num_vars,
                committed=len(circ.committed), steps=steps,
                prove_s=prove_s, prove_phases=phases, checks=checks,
                launches=launches, ok=all(checks.values()))
    return info


# ------------------------------------------- the pool: A8 and phase 12

POOL_B = 256                   # phase 12's curve batches
KEYGEN_BS = (1, 256, 1024)     # identities keyed through the c = 8 table
KEYGEN_CHECK_WINDOWS = 4       # a keygen profiled whole against the line
# (cut for the run's time limit, as AUDIT_PROOFS: the keygen batches from
# 1, 256, 4,096 and the journey from 32 / 8 / 8, the sized deposits from 2)
POOL_DEPOSITS, POOL_WITHDRAWS, POOL_DECRYPTS = 16, 8, 8
# the app at size: a store pre-filled with deposits, then a few more
POOL_PREFILL, SIZED_DEPOSITS, SIZED_WITHDRAWS = 1024, 1, 1


def _affine_add(name):
    return curve_ref.add if name == "embedded" else pr.g1_add


def _affine_mul(name, k):
    """[k]G by the host oracle: curve_ref on the embedded curve,
    pairing_ref on G1 (the identity as None)."""
    if name == "embedded":
        return curve_ref.scalar_mul(k)
    return pr.g1_mul(k, weierstrass.G1.gen)


def planted_curve_lanes(name, B, device, seed):
    """(P, Q, P + Q, 2Q) for B lanes on the card and host oracles: P a
    doubling (Z != 1), Q affine; lane 0 P = inf, 1 Q = inf, 2 both, 3
    P = Q at different Z, 4 P = -Q, 5 P = Q at equal limbs, the rest
    generic."""
    C = weierstrass.EMBEDDED if name == "embedded" else weierstrass.G1
    mod = C.F.modulus
    rng = random.Random(seed)
    half = [_affine_mul(name, rng.getrandbits(64) | 1) for _ in range(B)]
    two = [_affine_add(name)(h, h) for h in half]
    q = [_affine_mul(name, rng.getrandbits(64) | 1) for _ in range(B)]
    q[3], q[4] = two[3], (two[4][0], (-two[4][1]) % mod)
    P = [t.clone() for t in C.double(C.from_affine_ints(
        *zip(*half), device=device))]
    Q = [t.clone() for t in C.from_affine_ints(*zip(*q), device=device)]
    for i in range(3):
        P[i][5] = Q[i][5]
        for lane, T in ((0, P), (1, Q), (2, P), (2, Q)):
            T[i][lane] = 0
    p_aff = [None, two[1], None, two[3], two[4], q[5]] + two[6:]
    q_aff = [q[0], None, None] + q[3:]
    add = _affine_add(name)
    return (C, tuple(P), tuple(Q), [add(a, b) for a, b in zip(p_aff, q_aff)],
            [add(b, b) for b in q_aff])


def _affine_list(C, T):
    xs, ys = C.to_affine_ints(T)
    return [(int(x), int(y)) for x, y in zip(xs, ys)]


def _warm_call(fn, reps):
    """(warm ms by the host clock over ``reps`` synchronized calls, the
    kernel launches of one call and its copy and fill calls by
    torch.profiler, the output), after one unprofiled call that makes the
    first-use constants."""
    fn()
    _, launches, copies = device_launches(fn)
    ms, out = _host_ms(fn, reps)
    return ms, launches, copies, out


def _launch_line(step_fn, n):
    """({launch call: count}, {kernel: records}) of ``step_fn(n)``, a loop
    of n steps of one shape whose op sequence does not depend on the data
    (FieldCtx ops only), as base + n x step for each name, from
    torch.profiler over 1 and 2 steps."""
    one, two = (kernel_launches(lambda: step_fn(k))[1:3] for k in (1, 2))
    return launch_line(one[0], two[0], n), launch_line(one[1], two[1], n)


def _loop_call(step_fn, n):
    """(warm ms of ``step_fn(n)`` by the host clock, its kernel launches,
    its output). The launches are extrapolated by ``_launch_line``, since
    profiling a loop of 10^5 launches takes seconds to minutes;
    ``pool_curves`` holds one keygen's line to a whole profile of a few
    steps, launch call by launch call."""
    step_fn(1)                        # first-use constants, unprofiled
    launches = sum(_launch_line(step_fn, n)[0].values())
    ms, out = _host_ms(lambda: step_fn(n))
    return ms, launches, out


def pool_curves(device, B=POOL_B, seed=601):
    """A8 on the card (phase 12 a): ``CurveOps.add`` and ``double`` on
    planted lanes, ``scalar_mul`` (128 bits on the embedded curve, 64 on
    G1) and the c = 8 keygen table at each B of ``KEYGEN_BS``, each held
    to the host oracles in affine form; warm ms and launches a call; at B = 256
    the launch line against one profile of a ``KEYGEN_CHECK_WINDOWS``-window
    keygen."""
    info, checks = {}, {}
    for name, nbits in (("embedded", 128), ("g1", 64)):
        C, P, Q, want_add, want_dbl = planted_curve_lanes(name, B, device,
                                                          seed)
        for op, fn, want in (("add", lambda: C.add(P, Q), want_add),
                             ("double", lambda: C.double(Q), want_dbl)):
            ms, launches, copies, out = _warm_call(fn, 5)
            info[f"{name}_{op}"] = dict(B=B, ms=ms, launches=launches,
                                        copies=copies)
            checks[f"{name}_{op}"] = _affine_list(C, out) == [
                w or (0, 0) for w in want]
        rng = random.Random(seed + nbits)
        ks = [0, 1, (1 << nbits) - 1] + [rng.getrandbits(nbits)
                                          for _ in range(B - 3)]
        if name == "embedded":
            ks[3] = SECRET_KEY
        bits = torch.as_tensor(C.bits_from_ints(ks, nbits), device=device)
        G = C.from_affine_ints([C.gen[0]] * B, [C.gen[1]] * B, device=device)
        ms, launches, out = _loop_call(
            lambda n: C.scalar_mul(bits[:, :n], G), nbits)
        info[f"{name}_scalar_mul"] = dict(B=B, bits=nbits, ms=ms,
                                          launches=launches)
        got = _affine_list(C, out)
        checks[f"{name}_scalar_mul"] = got == [
            _affine_mul(name, k) or (0, 0) for k in ks]
        if name == "embedded":
            checks["scalar_mul_vector"] = got[3] == (OWNER_X, OWNER_Y)
    t0 = time.perf_counter()
    tbl = fixed_base.embedded_generator_table(8, device=device)
    info["table_s"] = time.perf_counter() - t0
    C = weierstrass.EMBEDDED
    rng = random.Random(seed + 1)
    ks = [SECRET_KEY, 0, 1, C.order - 1, (1 << 128) - 1] + [
        rng.getrandbits(128) for _ in range(max(KEYGEN_BS) - 5)]
    step = {}
    for b in KEYGEN_BS:
        digits = torch.as_tensor(tbl.digits(ks[:b]), device=device)
        ms, launches, out = _loop_call(lambda n: tbl.mul(digits[:, :n]),
                                       tbl.n_windows)
        row = info[f"keygen_B{b}"] = dict(B=b, c=8, windows=tbl.n_windows,
                                          ms=ms, launches=launches)
        if b == B:       # the extrapolation against one whole profile
            k = KEYGEN_CHECK_WINDOWS
            line, kernel_line = _launch_line(
                lambda n: tbl.mul(digits[:, :n]), k)
            t0 = time.perf_counter()
            _, whole, kernels, copies = kernel_launches(
                lambda: tbl.mul(digits[:, :k]))
            # the card's kernel records beside the count: the profiler
            # loses some, so they name a miss but do not decide it
            row.update(check_windows=k, launches_line=line,
                       launches_whole=whole, copies_whole=copies,
                       kernel_records_whole=sum(kernels.values()),
                       kernel_records_line_misses={
                           kern: (kernel_line.get(kern, 0),
                                  kernels.get(kern, 0))
                           for kern in kernel_line.keys() | kernels
                           if kernel_line.get(kern, 0)
                           != kernels.get(kern, 0)},
                       whole_profile_s=time.perf_counter() - t0)
            checks["keygen_launch_line"] = line == whole
        step[b] = kernel_launches(lambda: tbl.mul(digits[:, :1]))[2]
    # one window's kernels by name where B = 1 and B = 256 differ
    info["keygen_window_kernels_B1_B256"] = {
        k: (step[1].get(k, 0), step[B].get(k, 0))
        for k in sorted(set(step[1]) | set(step[B]))
        if step[1].get(k, 0) != step[B].get(k, 0)}
    t0 = time.perf_counter()
    got = _affine_list(C, out)
    checks["keygen_vector"] = got[0] == (OWNER_X, OWNER_Y)
    checks["keygen_oracle"] = got == [curve_ref.scalar_mul(k) or (0, 0)
                                      for k in ks]
    info["keygen_oracle_s"] = time.perf_counter() - t0
    return dict(info, checks=checks, ok=all(checks.values()))


def _http(base, method, path, body=None):
    """(status, JSON payload) of one request to the pool's server."""
    req = urllib.request.Request(
        base + path, method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stats(xs):
    return dict(n=len(xs), mean_s=sum(xs) / max(1, len(xs)),
                min_s=min(xs, default=0), max_s=max(xs, default=0))


@contextlib.contextmanager
def _served(app):
    """The base URL of ``make_server(app)`` on 127.0.0.1 at an ephemeral
    port, served from a thread; shut down and joined on exit."""
    srv = make_server(app, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        th.join()


def _timed_http(base, method, path, body=None):
    """(s, status, JSON payload) of one request."""
    t0 = time.perf_counter()
    code, payload = _http(base, method, path, body)
    return time.perf_counter() - t0, code, payload


def _deposits(base, rng, n):
    """n deposits over HTTP: (s of each, payload of each 200 else None)."""
    out = [_timed_http(base, "POST", "/api/deposit",
                       {"amount": rng.randrange(1, 10) * 1_000_000})
           for _ in range(n)]
    return [t for t, _, _ in out], [d if c == 200 else None
                                    for _, c, d in out]


def _withdrawals(base, rng, deps):
    """One withdrawal of each deposit to a distinct random recipient: (s of
    each, the recipients, all of them answered as sent)."""
    rcpts = [bytes(rng.getrandbits(8) for _ in range(32)).hex()
             for _ in deps]
    out = [_timed_http(base, "POST", "/api/withdraw",
                       {"commitment": d["commitment"], "recipient": r})
           for d, r in zip(deps, rcpts)]
    ok = all(c == 200 and w["recipient"] == "0000" + r[:60]
             and w["audit_was_new"] for (_, c, w), r in zip(out, rcpts))
    return [t for t, _, _ in out], rcpts, ok


def _records_hold(app, commitments):
    """The stored records of ``commitments`` against the host oracles:
    each commitment is poseidon_hash_ref of its fields, each sibling path
    proves it under the root stored beside it."""
    recs = [app.store.get_deposit(c) for c in commitments]
    return dict(commitments=all(
        int(r.commitment, 16) == poseidon_hash_ref(
            [int(r.public_key_x, 16), int(r.public_key_y, 16),
             int(r.amount), int(r.randomness, 16)]) for r in recs),
        deposit_paths=all(MerkleTree.verify_proof(
            int(r.commitment, 16), r.leaf_index,
            [int(v, 16) for v in r.siblings], int(r.root, 16))
            for r in recs))


def _device_root(leaves, device):
    """The root over ``leaves`` by ``build_levels`` on the card, the leaves
    zero-padded to a power of two."""
    pad = 1 << max(0, len(leaves) - 1).bit_length()
    leaves = list(leaves) + [0] * (pad - len(leaves))
    _, root = build_levels(torch.as_tensor(
        FR.to_mont(np.asarray(leaves, dtype=object)), device=device))
    return int(FR.from_mont(root))


def pool_journey(device, out_dir, seed=602):
    """The pool over HTTP (phase 12 b): a ``DemoApp`` on the card with its
    store in ``out_dir``, served by ``make_server`` on 127.0.0.1; the page,
    the status, POOL_DEPOSITS deposits, POOL_WITHDRAWS withdrawals to
    distinct recipients, a double spend (400, the typed nullifier error),
    POOL_DECRYPTS decrypts, the
    tables; K7's launches over those requests (one 16-level build a
    deposit); every stored commitment against ``poseidon_hash_ref``, every
    stored and withdrawn sibling path against the root it proves, the
    app's root against ``build_levels`` of the same leaves; then a second
    app on the same store."""
    rng = random.Random(seed)
    root = os.path.join(out_dir, "pool")
    rlwe_dir = write_rlwe_dir(os.path.join(root, "rlwe"))
    store = os.path.join(root, "store.json")
    info, checks = {}, {}
    app = DemoApp(store_path=store, rlwe_dir=rlwe_dir, fresh=True,
                  device=device)
    with _served(app) as base:
        hkern.reset_launches()        # the main path starts here
        with urllib.request.urlopen(base + "/") as r:
            checks["page"] = r.status == 200 and b"shielded pool" in r.read()
        code, st = _http(base, "GET", "/api/status")
        checks["status"] = code == 200 and st["leaves"] == 0
        dep_s, deps = _deposits(base, rng, POOL_DEPOSITS)
        checks["deposits"] = [d and d["leaf_index"] for d in deps] == list(
            range(POOL_DEPOSITS))
        picked = rng.sample(range(POOL_DEPOSITS), POOL_WITHDRAWS)
        wd_s, recipients, checks["withdrawals"] = _withdrawals(
            base, rng, [deps[i] for i in picked])
        code, err = _http(base, "POST", "/api/withdraw",
                          {"commitment": deps[picked[0]]["commitment"],
                           "recipient": recipients[0]})
        checks["double_spend"] = (
            code == 400 and "nullifier" in err.get("error", "")
            and err.get("hint") == perrors.RECOVERY_HINTS[
                perrors.ErrorCode.NULLIFIER_ALREADY_USED])
        dec = [_timed_http(base, "POST", "/api/decrypt",
                           {"commitment": deps[i]["commitment"]})
               for i in rng.sample(range(POOL_DEPOSITS), POOL_DECRYPTS)]
        checks["decrypts"] = all(c == 200 and d["matches_deposit"]
                                 for _, c, d in dec)
        table = _http(base, "GET", "/api/deposits")[1]["deposits"]
        audits = _http(base, "GET", "/api/audits")[1]["audits"]
        checks["tables"] = (
            len(table) == POOL_DEPOSITS and len(audits) == POOL_WITHDRAWS
            and sum(d["status"] == "withdrawn" for d in table)
            == POOL_WITHDRAWS)
        info["k7_launches"] = hkern.LAUNCHES["poseidon"]   # ... and ends
    checks["k7_launches"] = info["k7_launches"] == POOL_DEPOSITS * TREE_DEPTH
    # the host oracles
    t0 = time.perf_counter()
    checks.update(_records_hold(app, [d["commitment"] for d in deps]))
    final = app.tree.get_root()
    ok_paths = True
    for i in picked:
        r = app.store.get_deposit(deps[i]["commitment"])
        note = flows.Note(flows.Identity(int(r.secret_key, 16),
                                         int(r.public_key_x, 16),
                                         int(r.public_key_y, 16)),
                          amount=int(r.amount),
                          randomness=int(r.randomness, 16))
        w = flows.build_withdraw_witness(app.tree, note, r.leaf_index,
                                         b"\x00" * 32, note.amount)
        ok_paths &= w.root == final and MerkleTree.verify_proof(
            note.commitment, r.leaf_index, w.siblings, final)
        ok_paths &= hex(w.nullifier) in {a["nullifier"] for a in audits}
    checks["withdraw_paths"] = bool(ok_paths)
    checks["root"] = _device_root(app.tree.leaves, device) == final
    info["oracle_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = DemoApp(store_path=store, rlwe_dir=rlwe_dir, device=device)
    info["restart_s"] = time.perf_counter() - t0
    checks["restart"] = (again.tree.leaves == app.tree.leaves
                         and again.tree.get_root() == final
                         and again.status()["root_age"] == 0)
    info.update(leaves=len(app.tree.leaves), deposit=_stats(dep_s),
                withdraw=_stats(wd_s), decrypt=_stats([t for t, _, _ in dec]),
                store_mb=os.path.getsize(store) / 2 ** 20)
    os.remove(store)
    return dict(info, checks=checks, ok=all(checks.values()))


def pool_at_size(device, out_dir, seed=603):
    """The app at a pool's size (phase 12 b, second part). A store
    pre-filled with ``POOL_PREFILL`` deposits: identities keyed on the card
    by the c = 8 table, the records made by the port's
    ``deposit_record_from_flow`` (sibling paths from the pre-filled tree;
    every record shares the RLWE fields of one real encryption, so each
    has a deposit's size); a new ``DemoApp`` opens it (the restart re-inserts every leaf),
    then ``SIZED_DEPOSITS`` deposits, ``SIZED_WITHDRAWS`` withdrawals of
    them and one decrypt over HTTP, s a request, K7's launches over them;
    the new records against the host oracles, the root against
    ``build_levels`` on the card; one read and one rewrite of the store
    timed alone."""
    rng = random.Random(seed)
    rlwe_dir = os.path.join(out_dir, "pool", "rlwe")   # pool_journey's
    store = os.path.join(out_dir, "pool", "store-sized.json")
    info, checks = {}, {}
    t0 = time.perf_counter()
    sks = [rng.getrandbits(128) for _ in range(POOL_PREFILL)]
    xs, ys = weierstrass.EMBEDDED.to_affine_ints(
        fixed_base.embedded_generator_table(8, device=device).mul_ints(sks))
    notes = [flows.Note(flows.Identity(sk, int(x), int(y)),
                        amount=rng.randrange(1, 10) * 1_000_000,
                        randomness=rng.getrandbits(200))
             for sk, x, y in zip(sks, xs, ys)]
    leaves = [n.commitment for n in notes]
    paths = MerkleTree(device=device)
    paths.leaves = leaves             # get_proof reads the leaves alone
    filled = types.SimpleNamespace(get_proof=paths.get_proof)
    filled.root = _device_root(leaves, device)
    filled.get_root = lambda: filled.root
    kg = rlwe_ref.keygen(42)          # write_rlwe_dir's key
    enc = rlwe_ref.encrypt(kg["a"], kg["b"], int(xs[0]), int(ys[0]),
                           seed=rng.getrandbits(30))
    ct = audit_circuit.ct_commitment_of(enc)
    now = time.time()
    first = pstorage.deposit_record_from_flow(notes[0], filled, 0, enc, ct)
    recs = [first] + [pstorage.deposit_record_from_flow(n, filled, i)
                      for i, n in enumerate(notes[1:], start=1)]
    for r in recs:
        r.created_at = now
        r.rlwe_ciphertext, r.rlwe_noise, r.rlwe_quotients = (
            first.rlwe_ciphertext, first.rlwe_noise, first.rlwe_quotients)
        r.ct_commitment = first.ct_commitment
    st = pstorage.Store(store)
    st.import_deposits(recs)
    st.save_merkle_state([hex(v) for v in leaves], hex(filled.root))
    info["prefill_s"] = time.perf_counter() - t0
    info["store_mb_before"] = os.path.getsize(store) / 2 ** 20
    t0 = time.perf_counter()
    pstorage.Store(store)
    info["load_s"] = time.perf_counter() - t0     # the restart's JSON read
    t0 = time.perf_counter()
    app = DemoApp(store_path=store, rlwe_dir=rlwe_dir, device=device)
    info["restart_s"] = time.perf_counter() - t0
    checks["restart"] = (app.tree.leaves == leaves
                         and app.tree.get_root() == filled.root)
    with _served(app) as base:
        hkern.reset_launches()        # the main path starts here
        dep_s, deps = _deposits(base, rng, SIZED_DEPOSITS)
        checks["deposits"] = [d and d["leaf_index"] for d in deps] == list(
            range(POOL_PREFILL, POOL_PREFILL + SIZED_DEPOSITS))
        wd_s, _, checks["withdrawals"] = _withdrawals(
            base, rng, deps[:SIZED_WITHDRAWS])
        dec_s, code, dec = _timed_http(
            base, "POST", "/api/decrypt", {"commitment": deps[-1][
                "commitment"]})
        checks["decrypt"] = code == 200 and dec["matches_deposit"]
        info["k7_launches"] = hkern.LAUNCHES["poseidon"]   # ... and ends
    checks["k7_launches"] = info["k7_launches"] == (SIZED_DEPOSITS
                                                    * TREE_DEPTH)
    t0 = time.perf_counter()          # one rewrite of the whole store
    app.store.save_merkle_state([hex(v) for v in app.tree.leaves],
                                hex(app.tree.get_root()))
    info["rewrite_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks.update(_records_hold(app, [d["commitment"] for d in deps]))
    checks["root"] = (_device_root(app.tree.leaves, device)
                      == app.tree.get_root())
    info["oracle_s"] = time.perf_counter() - t0
    info.update(leaves=len(app.tree.leaves), deposit=_stats(dep_s),
                withdraw=_stats(wd_s), decrypt=_stats([dec_s]),
                store_mb=os.path.getsize(store) / 2 ** 20)
    os.remove(store)
    return dict(info, checks=checks, ok=all(checks.values()))


def _witness_blob(pub):
    n = len(pub)
    return struct.pack(">III", n, 0, n) + b"".join(
        (v % FR_MOD).to_bytes(32, "big") for v in pub)


def pool_wire(device, out_dir, withdraw, audit, flips=((1, 40), (2, 150))):
    """The wire format on real proofs (phase 12 c): each withdraw-shape
    proof of phase 4 bundled with an audit proof of phase 11
    (``emit_proof``, ``proof_hex.bundle``, ``save_bundle`` /
    ``load_bundle``), parsed back (``parse_proof``,
    ``parse_public_witness``) equal to the originals, and verified through
    ``verify_batch`` on the card; then one flipped byte in a withdraw and
    in an audit proof: exactly those two fail, at parsing or at
    verification."""
    checks, info = {}, {}
    path = os.path.join(out_dir, "pool", "proof-hex.json")
    legs = {"withdraw": [], "audit": []}
    parsed_ok = True
    for i, (proof, pub) in enumerate(withdraw["proofs"]):
        aproof, apub = audit["proofs"][i % len(audit["proofs"])]
        payload = proof_hex.bundle(proof, _witness_blob(pub), aproof,
                                   flows.audit_witness_blob(*apub))
        proof_hex.save_bundle(path, payload)
        loaded = proof_hex.load_bundle(path)
        for leg, orig, opub in (("withdraw", proof, pub),
                                ("audit", aproof, apub)):
            raw = bytes.fromhex(loaded[leg]["proof_hex"])
            wit = bytes.fromhex(loaded[leg]["witness_hex"])
            pf = gnark_fmt.parse_proof(raw)
            back = (pf.ar, pf.bs, pf.krs) + (
                (pf.commitments[0], pf.pok) if pf.commitments else ())
            parsed_ok &= back == tuple(orig)
            parsed_ok &= gnark_fmt.parse_public_witness(wit) == list(opub)
            legs[leg].append((raw, list(opub)))
    os.remove(path)
    checks["parsed"] = bool(parsed_ok)
    info["bytes"] = {k: sorted({len(r) for r, _ in v})
                     for k, v in legs.items()}
    for (leg, vk), (i, pos) in zip((("withdraw", withdraw["vk"]),
                                    ("audit", audit["vk"])), flips):
        rows = legs[leg][:len(withdraw["proofs"])]
        t0 = time.perf_counter()
        clean = _parse_and_verify(vk, rows, device)
        info[f"{leg}_verify_s"] = time.perf_counter() - t0
        bad = list(rows)
        raw = bytearray(bad[i][0])
        raw[pos] ^= 0x01
        bad[i] = (bytes(raw), bad[i][1])
        flipped = _parse_and_verify(vk, bad, device)
        checks[f"{leg}_valid"] = clean == ["ok"] * len(rows)
        checks[f"{leg}_flip"] = [j for j, s in enumerate(flipped)
                                 if s != "ok"] == [i]
        info[f"{leg}_flip"] = dict(proof=i, byte=pos, stage=flipped[i],
                                   n=len(rows))
    return dict(info, checks=checks, ok=all(checks.values()))


def _parse_and_verify(vk, rows, device):
    """Each wire proof's fate: "ok", "parse" (``parse_proof`` raised) or
    "verify" (``verify_batch`` on the card rejected it)."""
    fate, proofs, pubs, at = [], [], [], []
    for j, (raw, pub) in enumerate(rows):
        try:
            pf = gnark_fmt.parse_proof(raw)
        except (AssertionError, ValueError, struct.error):
            fate.append("parse")
            continue
        fate.append(None)
        proofs.append((pf.ar, pf.bs, pf.krs) + (
            (pf.commitments[0], pf.pok) if pf.commitments else ()))
        pubs.append(pub)
        at.append(j)
    got = tverify.verify_batch(vk, proofs, pubs, device=device)
    for j, ok in zip(at, got):
        fate[j] = "ok" if ok else "verify"
    return fate


# ----------------------------------- the withdraw proof from ACIR: phase 13

# the app's journey with real proofs
WD_DEPOSITS, WD_WITHDRAWS = 8, 4
# solves timed per path (the interpreter's take ~0.05-0.1 s each)
WD_SOLVES = 5
# the naive pairing's batch
PPIO_B = 4


def _load_script(rel):
    """A script of the checkout (``scripts/``, ``examples/``) as a module."""
    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vectors():
    """The committed withdraw vector (``tests/vectors.py``)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import vectors
    return vectors


def withdraw_program(out_dir):
    """Phase 13 (a): the depth-16 withdraw artifact written by
    ``scripts/withdraw_acir.py`` under ``out_dir``, parsed and converted;
    the committed vector solved by the interpreter and by the native
    ``CompiledSolver`` (equal, with the committed root, nullifier and
    wa_commitment), and a forged owner point (twice the real one, every
    other witness recomputed by the program without its MSM) leaving the
    R1CS unsatisfied. Returns (info, the artifact's path)."""
    vectors = _vectors()
    writer = _load_script(os.path.join("scripts", "withdraw_acir.py"))
    info, checks = {}, {}
    t0 = time.perf_counter()
    wp = writer.withdraw_program(16)
    os.makedirs(os.path.join(out_dir, "withdraw"), exist_ok=True)
    path = writer.write_artifact(
        os.path.join(out_dir, "withdraw", "withdraw.json"), wp.program, wp.abi)
    info["generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, prog = acir.load_artifact(path)
    info["parse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ar = acir_r1cs.convert(prog)
    info["convert_s"] = time.perf_counter() - t0
    circ = prog.circuits[0]
    info.update(opcodes=len(circ.opcodes),
                witnesses=circ.current_witness_index + 1,
                rows=len(ar.r1cs.a_rows), wires=ar.r1cs.num_vars,
                domain=1 << (len(ar.r1cs.a_rows) - 1).bit_length())
    ins = vectors.withdraw_inputs()
    ms, w = _host_ms(lambda: acir_solver.solve(prog, ins), WD_SOLVES)
    info["interpreter_s"] = ms / 1e3
    t0 = time.perf_counter()
    cs = solver_native.CompiledSolver(prog, ins)
    info["compile_s"] = time.perf_counter() - t0
    ms, wn = _host_ms(lambda: cs.solve(ins), 4 * WD_SOLVES)
    ms_raw, _ = _host_ms(lambda: cs.solve_raw(ins), 4 * WD_SOLVES)
    info.update(native_s=ms / 1e3, native_raw_s=ms_raw / 1e3)
    out = wp.outputs
    checks["native_equal"] = wn == w
    checks["committed"] = (w[out["root"]], w[out["nullifier"]],
                           w[out["wa_commitment"]]) == (
        vectors.ROOT, vectors.NULLIFIER, vectors.WA_COMMITMENT)
    full = acir_r1cs.build_witness(ar, w)
    checks["satisfied"] = ar.r1cs.is_satisfied(full)
    # the forged owner point
    forged_in, forged = writer.forged_owner(wp, ins, w)
    checks["forged_unsatisfied"] = not ar.r1cs.is_satisfied(
        acir_r1cs.build_witness(ar, forged))
    try:
        acir_solver.solve(prog, forged_in)
        checks["forged_unsolvable"] = False
    except acir_solver.SolveError:
        checks["forged_unsolvable"] = True
    return dict(info, checks=checks), path


def withdraw_app(device, out_dir, artifact, seed=1301):
    """Phase 13 (c): ``DemoApp(prover="groth16")`` on the card behind its
    HTTP server: WD_DEPOSITS deposits, WD_WITHDRAWS withdrawals to distinct
    recipients, each solved natively, proved on the card and verified by
    the pool through ``verify_batch`` (P1, P2), with its split; one proof
    of each checked again by ``refimpl`` on the host; four withdrawals of
    one deposit with wrong proofs (400, "proof verification failed"): one
    flipped byte of A's y and B replaced by a twist point outside G2's
    subgroup, which fail to parse (no P1 or P2 launch), and two well-formed
    ones that only the pairing check refuses, a real proof of another
    recipient and A negated (P1 and P2 launched for each); the deposit, still
    unspent, then withdrawn with a real proof; a double spend (400, the
    typed nullifier error). Launches of K1-K7, P1, P2 over the requests."""
    rng = random.Random(seed)
    root = os.path.join(out_dir, "withdraw")
    rlwe_dir = write_rlwe_dir(os.path.join(root, "rlwe"))
    store = os.path.join(root, "store.json")
    info, checks = {}, {}
    t0 = time.perf_counter()
    app = DemoApp(store_path=store, rlwe_dir=rlwe_dir, prover="groth16",
                  fresh=True, device=device, artifact=artifact)
    torch.cuda.synchronize()
    info["startup_s"] = time.perf_counter() - t0
    sent = []                            # (proof bytes, witness) a request
    real_prove = app._prove_withdraw
    tamper = {"how": None}

    def recorded(wit, timings):
        if tamper["how"] == "recipient":  # a real proof of another recipient
            proof = real_prove(dataclasses.replace(
                wit, recipient_field=wit.recipient_field + 1), timings)
        else:
            proof = real_prove(wit, timings)
        if tamper["how"] == "flip":      # one flipped byte of A's y
            raw = bytearray(proof)
            raw[40] ^= 0x01
            proof = bytes(raw)
        elif tamper["how"] == "neg_a":   # A replaced by -A, still on G1
            y = int.from_bytes(proof[32:64], "big")
            proof = (proof[:32] + (FP_MOD - y).to_bytes(32, "big")
                     + proof[64:])
        elif tamper["how"] == "b_subgroup":  # B on the twist, outside G2
            (a0, a1), (b0, b1) = pr.twist_point_outside_g2(seed)
            proof = (proof[:64] + b"".join(v.to_bytes(32, "big")
                                           for v in (a1, a0, b1, b0))
                     + proof[192:])
        sent.append((proof, wit))
        return proof

    app._prove_withdraw = recorded
    with _served(app) as base:
        for reset in (kernels.reset_launches, hkern.reset_launches,
                      pkern.reset_launches):
            reset()                          # the main path starts here
        dep_s, deps = _deposits(base, rng, WD_DEPOSITS)
        checks["deposits"] = [d and d["leaf_index"] for d in deps] == list(
            range(WD_DEPOSITS))
        rcpts = [bytes(rng.getrandbits(8) for _ in range(32)).hex()
                 for _ in range(WD_WITHDRAWS + 1)]
        wds = [_timed_http(base, "POST", "/api/withdraw",
                           {"commitment": d["commitment"], "recipient": r})
               for d, r in zip(deps, rcpts[:WD_WITHDRAWS])]
        checks["withdrawals"] = all(
            c == 200 and w["recipient"] == "0000" + r[:60]
            for (_, c, w), r in zip(wds, rcpts))
        # four wrong proofs of one deposit, each refused by the pool's
        # verifier: one flipped byte of A's y (off the curve) and B on the
        # twist outside G2's subgroup, which fail to parse, a real proof of
        # another recipient and A negated (both well formed, so P1 and P2
        # reject them)
        victim = deps[WD_WITHDRAWS]["commitment"]
        rejected = {}
        for how in ("flip", "recipient", "neg_a", "b_subgroup"):
            before = dict(pkern.LAUNCHES)
            tamper["how"] = how
            code, err = _http(base, "POST", "/api/withdraw",
                              {"commitment": victim, "recipient": rcpts[-1]})
            tamper["how"] = None
            rejected[how] = dict(code=code, error=err.get("error"), **{
                k: pkern.LAUNCHES[k] - before[k] for k in before})
            checks[how] = (code == 400 and "proof verification failed"
                           in err.get("error", ""))
        checks["paired"] = all(rejected[how][k] > 0
                               for how in ("recipient", "neg_a")
                               for k in pkern.LAUNCHES)
        checks["unpaired"] = all(rejected[how][k] == 0
                                 for how in ("flip", "b_subgroup")
                                 for k in pkern.LAUNCHES)
        fresh_s, code, w = _timed_http(base, "POST", "/api/withdraw",
                                       {"commitment": victim,
                                        "recipient": rcpts[-1]})
        checks["after_rejects"] = code == 200
        code, err = _http(base, "POST", "/api/withdraw",
                          {"commitment": deps[0]["commitment"],
                           "recipient": rcpts[0]})
        checks["double_spend"] = (
            code == 400 and "nullifier" in err.get("error", "")
            and err.get("hint") == perrors.RECOVERY_HINTS[
                perrors.ErrorCode.NULLIFIER_ALREADY_USED])
        launches = dict(kernels.LAUNCHES, poseidon=hkern.LAUNCHES["poseidon"],
                        **pkern.LAUNCHES)    # the main path ends here
    # the proofs sent: the flipped one and the one with B outside G2 no
    # longer parse, the others do; the first, against refimpl's verify on
    # the host
    parsed = []
    for proof, _ in sent:
        try:
            parsed.append(gnark_fmt.parse_proof(proof))
        except (AssertionError, ValueError):
            parsed.append(None)
    checks["sent"] = [p is not None for p in parsed] == (
        [True] * WD_WITHDRAWS + [False, True, True, False, True, True])
    pf, wit = parsed[0], sent[0][1]
    checks["host_verify"] = verify(app.circuit.vk, (pf.ar, pf.bs, pf.krs),
                                   wit.public_inputs())
    splits = [w["timings"] for _, c, w in wds if c == 200]
    info.update(deposit=_stats(dep_s), withdraw=_stats([t for t, _, _ in wds]),
                withdraw_split={k: _stats([sp[k] for sp in splits])
                                for k in ("solve_s", "witness_s", "prove_s",
                                          "verify_s")},
                withdraw_after_rejects_s=fresh_s, rejected=rejected,
                launches=launches,
                rows=len(app.circuit.ar.r1cs.a_rows))
    os.remove(store)
    return dict(info, checks=checks, ok=all(checks.values()))


def naive_pairing(device, B=PPIO_B, seed=1302):
    """Phase 13 (d): ``pairing_product_is_one`` on the card at B over two
    pairs, the lanes alternating e(P, Q) e(-P, Q) (true) and e(P, Q)
    e(-P, 2 Q) (false), against ``pairing_ref``; s of the one call (the
    Miller loops as torch ops, then P2) and its P1 / P2 launches."""
    rng = random.Random(seed)
    ps, qs, want = [[], []], [[], []], []
    for b in range(B):
        p = pr.g1_mul(rng.randrange(1, FR_MOD), (1, 2))
        q = pr.g2_mul(rng.randrange(1, FR_MOD), pr.G2_GEN)
        q2 = q if b % 2 == 0 else pr.g2_add(q, q)
        ps[0].append(p)
        ps[1].append((p[0], (-p[1]) % FP_MOD))
        qs[0].append(q)
        qs[1].append(q2)
        want.append(pr.f12_mul(pr.pairing(p, q), pr.pairing(ps[1][-1], q2))
                    == pr.F12_ONE)
    g1s = [pairing.g1_to_limbs(p, device) for p in ps]
    g2s = [pairing.g2_to_limbs(q, device) for q in qs]
    pkern.reset_launches()
    ms, got = _host_ms(lambda: pairing.pairing_product_is_one(g1s, g2s))
    checks = dict(reference=got.tolist() == want == [b % 2 == 0
                                                     for b in range(B)])
    return dict(B=B, s=ms / 1e3, launches=dict(pkern.LAUNCHES),
                checks=checks, ok=all(checks.values()))


NAIVE_TIMEOUT_S = 600          # the naive-pairing worker's own bound


def naive_pairing_worker(device="cuda:0"):
    """``--naive-pairing-worker``: ``naive_pairing`` in this process, its
    record printed on a ``NAIVE`` line."""
    rec = naive_pairing(torch.device(device))
    print("NAIVE " + json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


def naive_pairing_in_worker(out_dir, built):
    """Phase 13 (d) in a worker process of this script, started once
    ``built`` (P2's library) is done: its Miller loop is launch-bound on
    one host core and the card is otherwise idle while phase 1's
    compilers and phase 15's setup run, so it runs beside them. The
    worker's output goes to ``naive_pairing.log``; one that prints no
    record or outlives NAIVE_TIMEOUT_S raises."""
    built.result()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--naive-pairing-worker"], capture_output=True,
                         text=True, timeout=NAIVE_TIMEOUT_S)
    out = res.stdout + res.stderr
    with open(os.path.join(out_dir, "naive_pairing.log"), "w") as f:
        f.write(out)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("NAIVE ")]
    if not line:
        raise AssertionError(f"the naive-pairing worker failed (exit "
                             f"{res.returncode}):\n{out[-4000:]}")
    return dict(json.loads(line[-1][len("NAIVE "):]),
                worker_s=time.perf_counter() - t0)


def phase_withdraw(device, out_dir, ppio=None):
    """Phase 13: the withdraw proof from an ACIR program, (a) to (d);
    ``ppio``, (d)'s record where a worker ran it already."""
    t0 = time.perf_counter()
    prog, artifact = withdraw_program(out_dir)
    log(13, "program " + json.dumps(prog))
    e2e_mod = _load_script(os.path.join("examples", "torch_withdraw_e2e.py"))
    t1 = time.perf_counter()
    e2e = e2e_mod.main(["--artifact", artifact])
    e2e["total_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    _, prog_ar = acir.load_artifact(artifact)
    cached_setup(acir_r1cs.convert(prog_ar).r1cs)
    e2e["setup_warm_s"] = time.perf_counter() - t1
    log(13, "e2e " + json.dumps(e2e, default=str))
    app = withdraw_app(device, out_dir, artifact)
    log(13, "app " + json.dumps(app))
    ppio = naive_pairing(device) if ppio is None else ppio
    log(13, "naive pairing " + json.dumps(ppio))
    return dict(program=prog, e2e=e2e, app=app, naive_pairing=ppio,
                phase_s=time.perf_counter() - t0,
                ok=all(prog["checks"].values()) and app["ok"] and ppio["ok"])


# ------------------------------------------------- mesh: K9 and sharding

def _max_err(got, want):
    return int((got.long() - want.long()).abs().max().item())


def random_q(shape, device, seed):
    """Seeded int32 values in [0, q) made on the device."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, rlweq.Q, tuple(shape), generator=g,
                         device=device, dtype=torch.int32)


def k9_bound(D, rows, S, inverse, clock_hz, distinct_other=False):
    """(bound ms, bound_by) of one K9 stage over D slots of (rows, S): each
    shard read once and each output written once (4 B an element each),
    the partners' shards too where they are separate copies (ppermute),
    and tw once a slot, over the memory rate; against 5 32-bit
    multiply-adds a Montgomery product (the 64-bit product, the quotient
    word, m * q), one an element on the v side forward and on every side
    inverse, over the INT32 rate."""
    el = D * rows * S
    ops_s = 5 * (el if inverse else el // 2) / (INT32_LANES * clock_hz)
    bytes_s = ((8 + 4 * distinct_other) * el + 4 * D * S) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s > bytes_s
                                       else "bytes")


def stage_inputs(device, D, B, S, hd, seed):
    """A stage's inputs on the card: per slot y int32[B, S], its twiddle
    slice (a pair's two slots alike), its side, its partner d ^ hd; 0, 1
    and q - 1 planted: the nine pairs of them in the first nine words of a
    shard (a u slot's pattern against a v slot's), whole rows of each in
    its last three rows (B >= 4), and in the first twiddles."""
    edge = torch.tensor([0, 1, rlweq.Q - 1], dtype=torch.int32,
                        device=device)
    u = [(d // hd) % 2 == 0 for d in range(D)]
    ys = [random_q((B, S), device, seed + d) for d in range(D)]
    for y, ud in zip(ys, u):
        flat = y.view(-1)
        k = min(9, flat.numel())
        flat[:k] = (edge.repeat_interleave(3) if ud else edge.repeat(3))[:k]
        if B >= 4:
            y[-3:] = (edge if ud else edge.roll(1))[:, None]
    base = [random_q((S,), device, seed + 100 + j) for j in range(hd)]
    for t in base:
        k = min(9, S)
        t[:k] = edge.repeat(3)[:k]
    return ys, [base[d % hd] for d in range(D)], u, [d ^ hd for d in range(D)]


def check_exchange(device, B=40, S=256):
    """K9 against its twin on the card, any nonzero difference a failure:
    one shard (``butterfly``) at u = 0 and 1, forward and inverse, with
    random tw and tw = R mod q; then one stage over every slot of a D-slot
    virtual mesh (``exchange_butterfly``, one launch) at D = 2, 4, 8 (hd =
    D / 2), forward and inverse, rdma (the partners' own shards) and
    ppermute (``Mesh.ppermute``'s copies), at (B, S), at an odd S (single
    words) and at B = 1, each slot against ``butterfly_plain``. Returns
    ({case: max |kernel - twin|}, K9 launches)."""
    before = ntt_rdma.LAUNCHES["exchange_butterfly"]
    errs = {}
    ys, tws, _, _ = stage_inputs(device, 2, B, S, 1, 90)
    one = torch.full((S,), rlweq.R_MOD_Q, dtype=torch.int32, device=device)
    for inv in (False, True):
        for u in (0, 1):
            for name, t in (("tw", tws[0]), ("R", one)):
                got = ntt_rdma.butterfly(ys[0], ys[1], t, u, inverse=inv)
                want = ntt_rdma.butterfly_plain(ys[0], ys[1], t, u, inv)
                errs[("exchange_butterfly", 1, f"u={u} {name} inverse="
                      f"{int(inv)}")] = _max_err(got, want)
    for rows, cols in ((B, S), (B, S // 2 + 1), (1, S)):
        for D in (2, 4, 8):
            mesh = Mesh.virtual((D,), ("sp",), device)
            ys, tws, u, partners = stage_inputs(device, D, rows, cols,
                                                D // 2, 91 + D)
            for inv in (False, True):
                want = ntt_rdma.stage_plain(ys, [ys[p] for p in partners],
                                            tws, u, inv)
                for ex in ntt_sharded.EXCHANGES:
                    outs = ntt_rdma.exchange_butterfly(mesh, ys, tws, u,
                                                       partners, ex, inv)
                    torch.cuda.synchronize()
                    errs[("exchange_butterfly", D, f"{ex} ({rows}, {cols}) "
                          f"inverse={int(inv)}")] = max(
                              _max_err(o, w) for o, w in zip(outs, want))
    return errs, ntt_rdma.LAUNCHES["exchange_butterfly"] - before


def time_exchange(device, clock_hz, n=rlwe_ref.N, B=4096, D=8, reps=50):
    """K9 at phase 9's shape, the audit ring n over D shards, B
    polynomials: one forward stage over every slot (hd = 1, the partners'
    own shards, one launch) against its twin and bound, by CUDA events
    around ``reps`` launches from Python (``ms``) and around a CUDA graph
    of ``reps`` launches (``graph_ms``: the device time without the host's
    enqueue gaps; the inputs stay in L2), the inverse form in a graph
    too, and in a graph over four input sets in turn (``cold_graph_ms``:
    from device memory, as the bound counts); then the whole stage
    through the mesh (``exchange_butterfly``: its slot streams and events,
    ppermute with its copies) by the host clock around ``reps`` stages."""
    S = n // D
    mesh = Mesh.virtual((D,), ("sp",), device)
    ys, tws, u, partners = stage_inputs(device, D, B, S, 1, 100)
    others = [ys[p] for p in partners]
    outs = [torch.empty_like(y) for y in ys]
    run = lambda inv=False: ntt_rdma.stage(ys, others, tws, u, inv, outs)
    ms, got = _cuda_ms(run, reps)
    got = [g.clone() for g in got]
    plain_ms, want = _cuda_ms(
        lambda: ntt_rdma.stage_plain(ys, others, tws, u), 5)
    graph_ms = _graph_ms(run, reps)[0]
    err = max(_max_err(g, w) for g, w in zip(got, want))
    err = max(err, max(_max_err(g, w) for g, w in zip(outs, want)))
    inv_graph_ms = _graph_ms(lambda: run(True), reps)[0]
    want = ntt_rdma.stage_plain(ys, others, tws, u, True)
    err = max(err, max(_max_err(g, w) for g, w in zip(outs, want)))
    # the same stage over four input sets in turn (128 MB > the 50 MB L2)
    sets = [ys] + [stage_inputs(device, D, B, S, 1, 200 + 10 * k)[0]
                   for k in range(3)]
    set_outs = [[torch.empty_like(y) for y in c] for c in sets]
    turn = [0]

    def run_cold():
        i = turn[0] % len(sets)
        turn[0] += 1
        return ntt_rdma.stage(sets[i], [sets[i][p] for p in partners], tws,
                              u, False, set_outs[i])

    for _ in sets:
        run_cold()
    cold_graph_ms = _graph_ms(run_cold, reps)[0]
    for c, outs_c in zip(sets, set_outs):
        want = ntt_rdma.stage_plain(c, [c[p] for p in partners], tws, u)
        err = max(err, max(_max_err(g, w) for g, w in zip(outs_c, want)))
    bound_ms, bound_by = k9_bound(D, B, S, False, clock_hz)
    res = dict(ms=ms, graph_ms=graph_ms, inverse_graph_ms=inv_graph_ms,
               cold_graph_ms=cold_graph_ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_copies_ms=k9_bound(D, B, S, False, clock_hz, True)[0],
               shape=(D, B, S), max_abs_err=err, D=D, B=B)
    for ex in ntt_sharded.EXCHANGES:
        fn = lambda: ntt_rdma.exchange_butterfly(mesh, ys, tws, u, partners,
                                                 ex)
        fn()
        res[f"stage_{ex}_ms"] = _host_ms(fn, reps)[0]
    return res


def phase_ntt(device, n=rlwe_ref.N, B=4096, reps=3, samples=4):
    """The sharded negacyclic NTT at the audit ring (n = 1,024), B
    polynomials a side, on D = 2, 4, 8 virtual shards with both exchanges,
    every call a replay of the transform's CUDA graph (captured at the
    first call of each): forward equal to the single-device forward twice,
    the inverse round trip, ``reps`` + 2 products each equal to the
    single-device product (so equal under both exchanges), ``samples``
    rows of it equal to the schoolbook. Per run: K9 launches a product
    (counted at capture), ms a product by replay (host clock, and CUDA
    events: the device's time), and eager (the graph's code run directly,
    warm, host clock), beside the single-device product's."""
    a, b = random_q((B, n), device, 110), random_q((B, n), device, 111)
    f_ref = rntt.forward(a)
    single_ms, prod_ref = _host_ms(lambda: rntt.negacyclic_mul(a, b), reps)
    rows = random.Random(112).sample(range(B), samples)
    school = all(rlwe_ref.negacyclic_mul(x, y, n) == p for x, y, p in zip(
        a[rows].tolist(), b[rows].tolist(), prod_ref[rows].tolist()))
    info = dict(n=n, batch=B, single_ms=single_ms,
                single_polymuls_per_s=B / single_ms * 1e3,
                schoolbook_ok=school, runs={}, rdma_launches=0)
    ok = school
    for D in (2, 4, 8):
        mesh = Mesh.virtual((D,), ("sp",), device)
        for ex in ntt_sharded.EXCHANGES:
            fwd = lambda x: ntt_sharded.forward_sharded(x, mesh, exchange=ex)
            mul = lambda: ntt_sharded.negacyclic_mul_sharded(a, b, mesh,
                                                             exchange=ex)
            f = fwd(a)
            fwd_ok = torch.equal(f, f_ref) and torch.equal(fwd(a), f_ref)
            inv_ok = torch.equal(ntt_sharded.inverse_sharded(
                f, mesh, exchange=ex), a)
            ntt_rdma.reset_launches()
            t0 = time.perf_counter()
            mul_ok = torch.equal(mul(), prod_ref)
            capture_s = time.perf_counter() - t0
            launches = ntt_rdma.LAUNCHES["exchange_butterfly"]
            if ex == "rdma":
                info["rdma_launches"] += launches
            replay = []
            for _ in range(reps):
                ms, p = _host_ms(mul)
                replay.append(ms)
                mul_ok &= torch.equal(p, prod_ref)
            device_ms, p = _cuda_ms(mul, reps, warm=False)
            mul_ok &= torch.equal(p, prod_ref)
            sh = ntt_sharded._Shards(mesh, "sp", n, ex)
            eager = lambda: ntt_sharded._mul(sh, a, b)
            mul_ok &= torch.equal(eager(), prod_ref)          # warm
            eager_ms, p = _host_ms(eager, reps)
            mul_ok &= torch.equal(p, prod_ref)
            run = dict(forward_ok=fwd_ok, inverse_ok=inv_ok, mul_ok=mul_ok,
                       launches_per_product=launches,
                       launches_ok=launches == 3 * (D.bit_length() - 1),
                       capture_s=capture_s, ms=min(replay),
                       replay_ms=replay, device_ms=device_ms,
                       eager_ms=eager_ms,
                       polymuls_per_s=B / min(replay) * 1e3)
            ok &= fwd_ok and inv_ok and mul_ok and run["launches_ok"]
            info["runs"][f"D={D} {ex}"] = run
        del mesh
    info["ok"] = bool(ok and info["rdma_launches"] > 0)
    return info


def _g1_point(row):
    """(3, 1, 16) Jacobian row on the card -> affine ints (None = O)."""
    return tp._g1_affine(tuple(row[i, 0].cpu() for i in range(3)))


def phase_msm_sharded(device, g1):
    """Phase 3's 2^18 G1 MSM with the points sharded over dp = 2, 4, 8 and
    over a (host 2, chip 4) mesh (``hierarchical_fold``), each against
    phase 3's native-oracle point; cold and warm ms by the host clock.
    Returns the results and each case's affine point."""
    rows = torch.stack(g1["pts_dev"], 1)[:, :, None, :].contiguous()
    limbs = g1["limbs"]
    cases = [(f"dp={D}", Mesh.virtual((D,), ("dp",), device),
              msm_grid_sharded) for D in (2, 4, 8)]
    cases.append(("host=2 chip=4", Mesh.virtual((2, 4), ("host", "chip"),
                                                device), msm_grid_sharded_2d))
    res, points = {}, {}
    for name, mesh, msm in cases:
        cold, out = _host_ms(lambda: msm(rows, limbs, mesh))
        warm, out2 = _host_ms(lambda: msm(rows, limbs, mesh))
        points[name] = _g1_point(out)
        res[name] = dict(cold_ms=cold, warm_ms=warm, ok=(
            points[name] == _g1_point(out2) == g1["want"]))
    return res, points


def phase_legs(device, g1, n=1 << 14, seed=113):
    """Four seeded G1 legs of n points (the withdraw prover's leg size) on
    a (leg 4, pt 2) virtual mesh, each against the native oracle."""
    rng = random.Random(seed)
    pts = g1["pts"][:4 * n]
    rows = torch.stack(g1["pts_dev"], 1)[:4 * n, :, None, :] \
        .reshape(4, n, 3, 1, 16).contiguous()
    ks = [rng.randrange(1, FR_MOD) for _ in range(4 * n)]
    limbs = torch.as_tensor(ints_to_limbs(ks), device=device) \
        .reshape(4, n, 16)
    mesh = Mesh.virtual((4, 2), ("leg", "pt"), device)
    cold, _ = _host_ms(lambda: msm_legs_sharded(rows, limbs, mesh))
    warm, out = _host_ms(lambda: msm_legs_sharded(rows, limbs, mesh))
    oks = []
    for i in range(4):
        live = [(k, p) for k, p in zip(ks[i * n:(i + 1) * n],
                                       pts[i * n:(i + 1) * n])
                if p is not None]
        oks.append(_g1_point(out[i]) == native_bridge.g1_msm(
            [k for k, _ in live], [p for _, p in live]))
    return dict(n=n, cold_ms=cold, warm_ms=warm, legs_ok=oks, ok=all(oks))


def phase_dp_step(device, log2n=16, D=8):
    """2^log2n seeded leaves in D dp shards: a subtree per shard through K7
    on its own stream, the D roots gathered and combined on the first
    shard; the root against ``build_levels`` over all leaves on one
    device."""
    leaves = random_mont((1 << log2n,), device, seed=114)
    mesh = Mesh.virtual((D,), ("dp",), device)
    before = hkern.LAUNCHES["poseidon"]
    cold, root = _host_ms(lambda: root_sharded(leaves, mesh))
    launches = hkern.LAUNCHES["poseidon"] - before
    warm, root2 = _host_ms(lambda: root_sharded(leaves, mesh))
    _, want = build_levels(leaves, 16)
    return dict(leaves=1 << log2n, D=D, cold_ms=cold, warm_ms=warm,
                k7_launches=launches, ok=torch.equal(root, want)
                and torch.equal(root2, want))


# ------------------------------------ the pod path across processes: 14

POD_CHIPS = 4                  # virtual slots a process on the one card
POD_TIMEOUT_S = 300            # each worker's own bound
POD_GATHER_REPS = 20
POD_NTT_DS = (2, 8)            # the sharded NTT's meshes across processes
POD_NTT_REPS = 3
POD_STAGE_REPS = 5


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _point_json(p):
    return None if p is None else [str(v) for v in p]


def phase_pod(device, out_dir, g1, points9, merkle, ntt9):
    """Phase 14: two worker processes of this script (``--pod-worker``) on
    the one card, joined by ``multihost.initialize`` over Gloo (NCCL takes
    one card a rank), each with a (host 2, chip 4) ``pod_mesh`` of four
    virtual slots on cuda:0. Their inputs are phase 3's 2^18 G1 points and
    scalars and phase 6's 2^16 leaves, written here as .npy files (deleted
    after); each worker holds its MSM to phase 3's native-oracle point and
    phase 9's single-process (host 2, chip 4) point, and its root to phase
    6's; then runs the sharded NTT across the processes (``pod_ntt``),
    whose warm product ms is set here beside phase 9's single-process
    product at the same D and exchange (``ntt9``: graph replay and eager).
    A worker that fails, outlives its timeout or prints no sentinel raises
    here."""
    d = os.path.abspath(os.path.join(out_dir, "pod"))
    os.makedirs(d, exist_ok=True)
    torch.cuda.empty_cache()           # the card's memory for the workers
    try:
        rows = torch.stack(g1["pts_dev"], 1)[:, :, None, :]
        np.save(os.path.join(d, "rows.npy"), rows.cpu().numpy())
        np.save(os.path.join(d, "limbs.npy"), g1["limbs"].cpu().numpy())
        np.save(os.path.join(d, "leaves.npy"), random_mont(
            (1 << 16,), device, seed=16).cpu().numpy())
        with open(os.path.join(d, "want.json"), "w") as f:
            json.dump(dict(oracle=_point_json(g1["want"]),
                           single=_point_json(points9["host=2 chip=4"]),
                           root=merkle["root"]), f)
        port = _free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--pod-worker",
             str(r), str(port), d], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=POD_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall_s = time.perf_counter() - t0
    finally:
        for name in os.listdir(d):
            os.remove(os.path.join(d, name))
        os.rmdir(d)
    ranks = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        with open(os.path.join(out_dir, f"pod_worker{r}.log"), "w") as f:
            f.write(out)
        if p.returncode != 0 or f"POD{r}_OK" not in out:
            raise AssertionError(f"pod worker {r} failed (exit "
                                 f"{p.returncode}):\n{out[-4000:]}")
        line = [ln for ln in out.splitlines() if ln.startswith("POD ")]
        ranks.append(json.loads(line[-1][len("POD "):]))
    for r in ranks:
        for key, run in r["ntt"].items():
            one = ntt9["runs"][key]
            run.update(ratio_to_phase9=run["warm_ms"] / one["ms"],
                       ratio_to_phase9_eager=run["warm_ms"] / one["eager_ms"])
    return dict(ranks=ranks, wall_s=wall_s,
                ok=all(r["ok"] for r in ranks))


def pod_stage(device, mesh, D, B, S, ex, reps=POD_STAGE_REPS):
    """One exchange stage whose pairs cross the processes (hd = D / 2) at
    phase 9's shard shape, in one worker: with ``ex == "rdma"`` K9 reads
    each partner's shard through its CUDA IPC mapping, forward and inverse,
    each local slot held to ``stage_plain`` on the partner's shard copied
    by hand (``Mesh.ppermute``, through host memory) with 0, 1 and q - 1
    planted (``stage_inputs``); then, by the host clock, blocks of
    ``reps`` stages in a row (as a transform runs them: each stage's
    handshake releases the stage before, one ``settle`` a block) and of
    the exchange alone (``ppermute``'s copies, or the partner reads'
    synchronize, handshake and mapping), in turns, three of each: the
    median block's ms a stage, ms an exchange and its share of the
    stage."""
    hd = D // 2
    ys, tws, u, partners = stage_inputs(device, D, B, S, hd, 140 + D)
    ys = [y if s.local else None for y, s in zip(ys, mesh.slots)]
    tws = [t if s.local else None for t, s in zip(tws, mesh.slots)]
    res = dict(hd=hd, shard=(B, S))
    if ex == "rdma":
        copies = mesh.ppermute(ys, partners)
        err = 0
        for inv in (False, True):
            got = ntt_rdma.exchange_butterfly(mesh, ys, tws, u, partners,
                                              ex, inv)
            ntt_rdma.settle(mesh)
            for s in mesh.slots:
                if s.local:
                    want = ntt_rdma.butterfly_plain(
                        ys[s.index], copies[s.index], tws[s.index],
                        u[s.index], inv)
                    err = max(err, _max_err(got[s.index], want))
        res["ipc_read_max_abs_err"] = err

    def stages():
        for _ in range(reps):
            ntt_rdma.exchange_butterfly(mesh, ys, tws, u, partners, ex)
        ntt_rdma.settle(mesh)

    def exchanges():
        for _ in range(reps):
            if ex == "rdma":
                ntt_rdma.partner_reads(mesh, ys, partners)
            else:
                mesh.ppermute(ys, partners)
        ntt_rdma.settle(mesh)

    stages()                                   # warm
    times = {"stage_ms": [], "exchange_ms": []}
    for _ in range(3):
        for key, fn in (("stage_ms", stages), ("exchange_ms", exchanges)):
            times[key].append(_host_ms(fn)[0] / reps)
    for key, ts in times.items():
        res[key], res[key[:-3] + "_blocks_ms"] = float(np.median(ts)), ts
    res["exchange_share"] = res["exchange_ms"] / res["stage_ms"]
    return res


def pod_ntt(device, n=rlwe_ref.N, B=4096, reps=POD_NTT_REPS):
    """Phase 14's sharded NTT across the two processes, in one worker:
    phase 9's inputs (the audit ring n = 1,024, B polynomials a side, the
    same seeds) on ``span_mesh`` meshes of D = 2 (one slot a process,
    every cross stage crosses) and D = 8 (four a process, the first cross
    stage crosses), both exchanges, each an eager run (a CUDA graph holds
    one process's work). The product cold and ``reps`` times warm (host
    clock), each equal to the single-device ``rlwe.ntt.negacyclic_mul``;
    K9's launches over the cold product (3 log2 D: one a stage in a
    process); the forward equal to ``rlwe.ntt.forward`` and its inverse to
    the input; one crossing stage (``pod_stage``); and the product's last
    step alone, its result returned whole to every process
    (``Mesh.unshard``: the gather through host memory and the broadcast,
    median of ``reps``). Returns ({"D=.. ex": run}, ok)."""
    a, b = random_q((B, n), device, 110), random_q((B, n), device, 111)
    f_ref, prod_ref = rntt.forward(a), rntt.negacyclic_mul(a, b)
    runs, ok = {}, True
    for D in POD_NTT_DS:
        mesh = span_mesh(device=device, chips=D // 2)
        for ex in ntt_sharded.EXCHANGES:
            mul = lambda: ntt_sharded.negacyclic_mul_sharded(a, b, mesh,
                                                             exchange=ex)
            ntt_rdma.reset_launches()
            cold, p = _host_ms(mul)
            launches = ntt_rdma.LAUNCHES["exchange_butterfly"]
            mul_ok = torch.equal(p, prod_ref)
            warm = []
            for _ in range(reps):
                ms, p = _host_ms(mul)
                warm.append(ms)
                mul_ok &= torch.equal(p, prod_ref)
            f = ntt_sharded.forward_sharded(a, mesh, exchange=ex)
            run = dict(
                mul_ok=mul_ok, forward_ok=torch.equal(f, f_ref),
                inverse_ok=torch.equal(ntt_sharded.inverse_sharded(
                    f, mesh, exchange=ex), a),
                launches_per_product=launches,
                launches_ok=launches == 3 * (D.bit_length() - 1),
                cold_ms=cold, warm_ms=min(warm), warm_all_ms=warm,
                stage=pod_stage(device, mesh, D, B, n // D, ex))
            if ex == "rdma":             # the same step under either
                pieces = mesh.shard(p, ntt_sharded._spec(p, "sp"))
                run["unshard_ms"] = float(np.median([_host_ms(
                    lambda: mesh.unshard(pieces, "sp", device))[0]
                    for _ in range(reps)]))
            run["ipc_read_ok"] = run["stage"].get("ipc_read_max_abs_err",
                                                  0) == 0
            ok &= all(run[k] for k in ("mul_ok", "forward_ok", "inverse_ok",
                                       "launches_ok", "ipc_read_ok"))
            runs[f"D={D} {ex}"] = run
        del mesh
    return runs, bool(ok)


def pod_worker(rank, port, d, device="cuda:0"):
    """One process of phase 14 (``--pod-worker RANK PORT DIR``): start the
    runtime, build the pod mesh, run the 2^18 G1 MSM (host 2, chip 4) cold
    and warm, time the cross-process gather of one partial a process (the
    host axis of ``hierarchical_fold``: W = 20 window sums of (3, 1, 16)
    int64, staged through host memory for Gloo), the 2^16-leaf root
    over the eight slots of both processes, and the sharded NTT across the
    processes (``pod_ntt``); print one "POD" JSON line, and the sentinel
    only if every check held."""
    device = torch.device(device)
    t0 = time.perf_counter()
    initialize(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
               backend="gloo",
               timeout=datetime.timedelta(seconds=POD_TIMEOUT_S))
    init_s = time.perf_counter() - t0
    mesh = pod_mesh(device=device, chips=POD_CHIPS)

    def load(name):
        return torch.from_numpy(np.load(os.path.join(d, name + ".npy"))) \
            .to(device)

    rows, limbs, leaves = load("rows"), load("limbs"), load("leaves")
    with open(os.path.join(d, "want.json")) as f:
        want = json.load(f)
    kernels.reset_launches()
    hkern.reset_launches()               # the pod path starts here
    cold, out = _host_ms(lambda: msm_grid_sharded_2d(rows, limbs, mesh))
    warm, out2 = _host_ms(lambda: msm_grid_sharded_2d(rows, limbs, mesh))
    points = [_point_json(_g1_point(o)) for o in (out, out2)]
    # the host axis's gather alone: one partial a process, on its first slot
    part = torch.full((grid.n_windows(13), 3, 1, 16), rank + 1,
                      dtype=torch.int64, device=device)
    vals = [part if s.local and mesh.coord(s, "chip") == 0 else None
            for s in mesh.slots]
    gather_ms = []
    for _ in range(POD_GATHER_REPS):
        ms, g = _host_ms(lambda: mesh.all_gather(vals, "host"))
        gather_ms.append(ms)
    gathered_ok = (g[0] is None if rank else bool(
        (g[0][1] == 2).all() and (g[0][0] == 1).all()))
    root_cold, root = _host_ms(lambda: root_sharded(
        leaves, mesh, axis=("host", "chip")))
    root_warm, root2 = _host_ms(lambda: root_sharded(
        leaves, mesh, axis=("host", "chip")))
    launches = dict(kernels.LAUNCHES, poseidon=hkern.LAUNCHES["poseidon"])
    roots = [str(int(FR.from_mont(t.cpu()))) for t in (root, root2)]
    ntt_runs, ntt_ok = pod_ntt(device)
    checks = dict(
        msm_oracle=points == [want["oracle"]] * 2,
        msm_single=points[0] == want["single"],
        gather=gathered_ok,
        root=roots == [want["root"]] * 2,
        launches=all(launches[k] > 0 for k in (
            "prefix_rows", "wsum", "addn", "scale_add", "poseidon"))
        and (launches["horner"] > 0) == (rank == 0),
        ntt=ntt_ok)
    ok = all(checks.values())
    print("POD " + json.dumps(dict(
        rank=rank, slots=[s.index for s in mesh.slots if s.local],
        init_s=init_s, msm_cold_ms=cold, msm_warm_ms=warm,
        gather_ms=dict(min=min(gather_ms), median=float(np.median(
            gather_ms)), bytes=part.numel() * 8),
        root_cold_ms=root_cold, root_warm_ms=root_warm, launches=launches,
        ntt=ntt_runs, checks=checks, ok=ok), default=str), flush=True)
    torch.distributed.destroy_process_group()
    if ok:
        print(f"POD{rank}_OK", flush=True)
    return 0 if ok else 1


def log_pod_ntt(r):
    """Phase 14's line a (rank, mesh, exchange) of the sharded NTT."""
    for key, run in r["ntt"].items():
        st = run["stage"]
        log(14, f"rank {r['rank']} NTT {key} across processes: product "
                f"cold {run['cold_ms']:.2f} ms, warm {run['warm_ms']:.2f} "
                f"ms {json.dumps(run['warm_all_ms'])} (x"
                f"{run['ratio_to_phase9']:.2f} phase 9's replay, x"
                f"{run['ratio_to_phase9_eager']:.2f} its eager run); K9 "
                f"{run['launches_per_product']} launches a product; a "
                f"crossing stage (hd = {st['hd']}) {st['stage_ms']:.3f} ms, "
                f"its exchange {st['exchange_ms']:.3f} ms (share "
                f"{st['exchange_share']:.3f})" + (
                    f", IPC read against the twin max |err| "
                    f"{st['ipc_read_max_abs_err']}; the result returned "
                    f"whole to both processes alone {run['unshard_ms']:.2f}"
                    f" ms" if "ipc_read_max_abs_err" in st else "")
            + "; ok " + json.dumps({k: run[k] for k in (
                "mul_ok", "forward_ok", "inverse_ok", "launches_ok",
                "ipc_read_ok")}))


# ------------------------------- the prover's H(X): P4 and P5 (phase 2)

FR_ROW = 14                    # the kernels line's rows: the withdraw
                               # proof's domain 2^14, its 3 polynomials
FR_SMALL = 10                  # P4 at every (h_first, count) of n = 2 .. 2^10
FR_BIG = 21                    # whole transforms at the var-PK domain 2^21
# P4's fused steps held on and off: (pre, bitrev, post, post_scalar,
# quotient, in place); each alone, the coset inverse's last pass with the
# demont scalar folded in, all at once, and in place (bitrev is never)
FR_PASS_MODES = {"plain": (0, 0, 0, 0, 0, 0), "pre": (1, 0, 0, 0, 0, 0),
                 "bitrev": (0, 1, 0, 0, 0, 0), "post": (0, 0, 1, 0, 0, 0),
                 "scalar": (0, 0, 0, 1, 0, 0), "quotient": (0, 0, 0, 0, 1, 0),
                 "demont": (0, 0, 1, 1, 1, 0), "all": (1, 1, 1, 1, 1, 0),
                 "in place": (1, 0, 1, 1, 1, 1)}


def fr_planted(shape, device, seed, share=4):
    """``random_mont`` values with about 1 in ``share`` replaced by 0, 1 or
    r - 1 (canonical limbs)."""
    x = random_mont(shape, device, seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    edge = torch.as_tensor(ints_to_limbs([0, 1, FR_MOD - 1]), device=device)
    pick = torch.randint(0, 3 * share, tuple(shape), generator=g,
                         device=device)
    return torch.where((pick < 3)[..., None], edge[pick.clamp(max=2)], x)


class _PassInputs:
    """One size's planted inputs of ``check_fr_ntt``: values y and the
    quotient's b, c (P, n), the power table pw (n/2) and the tables (2, n)
    as limbs and packed words, a scalar, the quotient's t and the demont
    scalar n^-1 (plain)."""

    def __init__(self, P, n, device, seed):
        self.y, self.qb, self.qc = (fr_planted((P, n), device, seed + i)
                                    for i in (0, 1, 2))
        self.pw = fr_planted((n // 2,), device, seed + 50)
        self.tabs = fr_planted((2, n), device, seed + 100)
        self.pw_w, self.tabs_w = (domain.pack_words(t) for t in (self.pw,
                                                                 self.tabs))
        self.scalar = fr_planted((), device, seed + 150, share=1)
        self.qt = fr_planted((), device, seed + 151, share=1)
        self.demont = torch.as_tensor(ints_to_limbs(pow(n, -1, FR_MOD)),
                                      device=device)

    def kw(self, mode, P=None):
        """``fr_pass`` / ``pass_plain`` keywords of ``mode`` (on the first
        P polynomials)."""
        pre, br, post, sc, q, _ = FR_PASS_MODES[mode]
        return dict(pre=self.tabs_w[0] if pre else None, bitrev=bool(br),
                    post=self.tabs_w[1] if post else None,
                    post_scalar=(self.demont if mode == "demont"
                                 else self.scalar) if sc else None,
                    quotient=(self.qb[:P], self.qc[:P], self.qt) if q
                    else None)


def _pass(inp, P, h_first, count, dif, mode):
    """P4 in ``mode`` over the first P polynomials, on a copy of y when in
    place (its input kept for the twin)."""
    y = inp.y[:P]
    out = y.clone() if FR_PASS_MODES[mode][5] else None
    return nkern.fr_pass(out if out is not None else y, inp.pw_w, h_first,
                         count, dif, out=out, **inp.kw(mode, P))


def _pass_chains(inp, h_first, cmax, dif):
    """``pass_plain`` of every mode of FR_PASS_MODES at counts 1 .. cmax
    from ``h_first`` on the largest P, in one batched chain: each mode's
    pass inputs (its gather, quotient and ``pre``, which multiplies the
    first stage's inputs) stacked on a leading axis, one ``stage_plain`` a
    count over all of them, ``post`` and the scalar a count on copies of
    the modes that take them (the same steps, so the same limbs, as
    ``pass_plain``, which the CPU tests hold to JAX and to the kernel's
    host build). {mode: [want at count 1, ..., cmax]}."""
    n = inp.y.shape[-2]
    perm = torch.as_tensor(domain.bitrev_perm(n), device=inp.y.device)
    modes = list(FR_PASS_MODES)
    starts, posts, scals, scalars = [], [], [], []
    for i, mode in enumerate(modes):
        pre, br, post, sc, q, _ = FR_PASS_MODES[mode]
        y, b, c = ((t[..., perm, :] for t in (inp.y, inp.qb, inp.qc)) if br
                   else (inp.y, inp.qb, inp.qc))
        if q:
            y = domain.quotient_plain(y, b, c, inp.qt)
        if pre:
            y = FR.mont_mul(y, inp.tabs[0])
        starts.append(y)
        posts += [i] if post else []
        if sc:
            scals.append(i)
            scalars.append(inp.demont if mode == "demont" else inp.scalar)
    x = torch.stack(starts)                 # (modes, P, n, 16)
    scalars = torch.stack(scalars)[:, None, None]
    wants = []
    for c in range(cmax):
        h = h_first >> c if dif else h_first << c
        x = domain.stage_plain(x, inp.pw[:: n // (2 * h)], dif)
        out = x.clone()
        out[posts] = FR.mont_mul(out[posts], inp.tabs[1])
        out[scals] = FR.mont_mul(out[scals], scalars)
        wants.append(out)
    return {mode: [w[i] for w in wants] for i, mode in enumerate(modes)}


def check_fr_ntt(device, small=FR_SMALL, Ps=(1, 3), row=FR_ROW, big=FR_BIG,
                 seed=700):
    """P4 against ``pass_plain`` limb for limb at every (h_first, count) of
    n = 2 ... 2^small (every count fits a tile), both directions, P = 1
    and 3, in every mode of FR_PASS_MODES, with 0, 1 and r - 1 planted in
    the values, the twiddles and the tables; at n = 2^row, P = 3, the
    plan's passes in each direction, plain and in the prover's fused modes,
    and count = 1 at h = n/2 and 1; at n = 2^big, P = 1, a whole two-pass
    ``domain.forward`` and ``inverse`` against ``forward_plain`` and
    ``inverse_plain``; P5 against FieldCtx's products by R^2 and by 1, out
    of place and in place, at the proof's 3 x 2^14 values and a ragged
    count. Returns {(name, n, case):
    max |err|}, P4's launches and the launches the cases make (one a pass,
    a plan's a transform)."""
    errs = {}
    nkern.reset_launches()
    want_launches = 0
    for log_n in range(1, small + 1):
        n = 1 << log_n
        inp = _PassInputs(max(Ps), n, device, seed + log_n)
        for dif in (True, False):
            for lo in range(log_n):
                cmax = log_n - lo          # counts from this end
                h_first = 1 << (log_n - 1 - lo if dif else lo)
                chains = _pass_chains(inp, h_first, cmax, dif)
                for mode in FR_PASS_MODES:
                    # each polynomial's pass is its own: P = 1 is held to
                    # the first row of the largest P's plain pass
                    for count, want in enumerate(chains[mode], 1):
                        for P in Ps:
                            got = _pass(inp, P, h_first, count, dif, mode)
                            errs[("fr_pass", n, (h_first, count, dif, P,
                                                 mode))] = _max_err(
                                got, want[:P])
                            want_launches += 1
    n, P = 1 << row, max(Ps)
    inp = _PassInputs(P, n, device, seed + row)
    tile = nkern.max_pass(device)
    plan = domain.pass_plan(row, tile)
    for dif in (True, False):
        cases, bit = [], row if dif else 0
        for p, count in enumerate(plan):
            h = 1 << (bit - 1 if dif else bit)
            modes = ["plain"] + ((["pre"] if dif else ["bitrev", "quotient"])
                                 if p == 0 else [] if dif else ["demont"])
            cases += [(h, count, m) for m in modes]
            bit += -count if dif else count
        cases += [(n // 2, 1, "plain"), (1, 1, "plain")]
        for h, count, mode in cases:
            want = domain.pass_plain(inp.y, inp.pw_w, h, count, dif,
                                     **inp.kw(mode))
            errs[("fr_pass", n, (h, count, dif, P, mode))] = _max_err(
                _pass(inp, P, h, count, dif, mode), want)
            want_launches += 1
            del want
    yb = fr_planted((1, 1 << big), device, seed + 200)
    for name, fn, plain in (("forward", domain.forward, domain.forward_plain),
                            ("inverse", domain.inverse, domain.inverse_plain)):
        want = plain(yb)
        errs[("fr_pass", 1 << big, (name, 1, "transform"))] = _max_err(
            fn(yb), want)
        want_launches += len(domain.pass_plan(big, tile))
        del want
    pass_launches = nkern.LAUNCHES["fr_pass"]
    r2 = torch.as_tensor(ints_to_limbs(FR.r2_mod_p), device=device)
    one = torch.as_tensor(ints_to_limbs(1), device=device)
    for N in (3 << FR_ROW, 1000):
        a = fr_planted((N,), device, seed + 300 + N)
        for mode, t in (("R^2", r2), ("1", one)):
            want = FR.mont_mul(a, t)
            errs[("fr_pointwise", N, mode)] = _max_err(
                nkern.pointwise(a, t), want)
            x2 = a.clone()
            errs[("fr_pointwise", N, mode + ", in place")] = _max_err(
                nkern.pointwise(x2, t, out=x2), want)
    return errs, pass_launches, want_launches


def fr_pass_bound(P, log_n, h_first, count, dif, clock_hz, products=0,
                  tables=0, quotient=False):
    """(bound ms, bound_by) of one P4 pass: P n values read and written
    once (int64 limbs, 128 B a value; with the quotient b and c read too),
    the pass's distinct twiddles (2^(top stage), 32 B packed) and
    ``tables`` per-element tables (32 B a value) read once, against count
    n/2 butterfly products a polynomial and ``products`` fused products a
    value (pre, post, scalar; the quotient's two)."""
    n = 1 << log_n
    top = h_first if dif else h_first << (count - 1)
    nbytes = ((4 if quotient else 2) * P * n * 128 + top * 32
              + tables * n * 32)
    prods = P * (n // 2) * count + P * n * (products + 2 * quotient)
    ops_s = prods * MADDS_PER_FP_MUL / (INT32_LANES * clock_hz)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def fr_transform_bound(P, log_n, dif, clock_hz, plan, first=None,
                       last=None):
    """(bound ms, bound_by) of a transform through the passes of ``plan``
    (``pass_plan``'s): the sum of ``fr_pass_bound`` over them, ``first`` /
    ``last`` the fused keywords of its first / last pass; bound_by the
    larger part's."""
    bit = log_n if dif else 0
    total, by = 0.0, {}
    for p, count in enumerate(plan):
        kw = {}
        for part, on in ((first, p == 0), (last, p == len(plan) - 1)):
            for k, v in (part or {}).items() if on else ():
                kw[k] = kw.get(k, 0) + v
        ms, b = fr_pass_bound(P, log_n, 1 << (bit - 1 if dif else bit),
                              count, dif, clock_hz, **kw)
        total += ms
        by[b] = by.get(b, 0.0) + ms
        bit += -count if dif else count
    return total, max(by, key=by.get)


def fr_pointwise_bound(N, clock_hz):
    """(bound ms, bound_by) of one P5 launch over N values: a and t read
    once, the output written once, one product a value."""
    nbytes = (2 * N + 1) * 128
    madds = N * MADDS_PER_FP_MUL
    ops_s = madds / (INT32_LANES * clock_hz)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _fr_row(ms, got, want, shape, bound, plain_ms=None):
    row = dict(shape=shape, ms=ms, max_abs_err=_max_err(got, want),
               bound_ms=bound[0], bound_by=bound[1])
    if plain_ms is not None:
        row["plain_ms"] = plain_ms
    return row


def fr_transforms(t, y, quotient=None):
    """The prover's transforms through P4 on y (P, n, 16) with the domain's
    tables ``t``, and their plain forms: {name: (kernel fn, plain fn,
    first-pass and last-pass fused products and tables, direction)}. The
    coset inverse carries the quotient (``quotient = (b, c, t)``) and the
    demont scalar, as ``prove._h_finish`` runs it."""
    b, c, tq = quotient
    return {
        "forward": (lambda: domain.forward(y, t["fwd"]),
                    lambda: domain.forward_plain(y, t["fwd"]), {}, {}, True),
        "inverse": (lambda: domain.inverse(y, t["inv"], t["ninv"]),
                    lambda: domain.inverse_plain(y, t["inv"], t["ninv"]), {},
                    dict(products=1), False),
        "interpolate_natural": (
            lambda: domain.interpolate_natural(y, t["br"], t["inv"],
                                               t["ninv"]),
            lambda: domain.inverse_plain(y[..., t["br"], :], t["inv"],
                                         t["ninv"]), {}, dict(products=1),
            False),
        "coset_forward": (
            lambda: domain.coset_forward(y, t["coset"], t["fwd"]),
            lambda: domain.forward_plain(FR.mont_mul(y, t["coset"]),
                                         t["fwd"]),
            dict(products=1, tables=1), {}, True),
        "coset_inverse, quotient, demont": (
            lambda: domain.coset_inverse(y, t["coset_inv"], t["inv"],
                                         t["ninv_demont"],
                                         quotient=(b, c, tq)),
            lambda: FR.mont_mul(domain.inverse_plain(
                domain.quotient_plain(y, b, c, tq), t["inv"],
                t["ninv_demont"]), t["coset_inv"]),
            dict(quotient=True), dict(products=2, tables=1), False)}


def time_fr_ntt(device, clock_hz, log_n=FR_ROW, P=3, big=FR_BIG, reps=50,
                seed=750):
    """P4's transforms and P5 by CUDA events (mean of ``reps`` calls after a
    warm one) and in a CUDA graph (``graph_ms``: the device's time without
    the host's launch gaps) beside their plain versions on the card (host
    clock, synchronized) and their bounds (``fr_transform_bound``). P4:
    each of the prover's transforms (``fr_transforms``) at n = 2^14, P = 3
    (the row: the forward transform, ``pass_plan``'s 2 launches), the
    forward and the coset inverse at n = 2^21, P = 1, and the two passes of
    the 2^21 forward transform alone. P5 (the row): the R^2 step of the
    3 n evaluations, its one launch a proof since the passes took the
    quotient and the demont step."""
    rows = {}
    tile = nkern.max_pass(device)
    for lg, p, r in ((log_n, P, reps), (big, 1, max(reps // 5, 3))):
        n = 1 << lg
        plan = domain.pass_plan(lg, tile)
        t = domain.tables(n, device)
        y, b, c = (random_mont((p, n), device, seed + i) for i in range(3))
        tq = random_mont((), device, seed + 3)
        for name, (fn, plain, first, last, dif) in fr_transforms(
                t, y, (b, c, tq)).items():
            if lg == big and name not in ("forward",
                                          "coset_inverse, quotient, demont"):
                continue
            ms, got = _cuda_ms(fn, r)
            pms, want = _host_ms(plain, 1 if lg == big else 3)
            row = rows[f"{name} 2^{lg}"] = _fr_row(
                ms, got, want, f"{name}, n=2^{lg}, P={p}, "
                f"{len(plan)} passes",
                fr_transform_bound(p, lg, dif, clock_hz, plan, first, last),
                pms)
            del got, want
            row["graph_ms"] = _graph_ms(fn, r)[0]
        if lg == big:              # each pass of the forward transform alone
            bit = lg
            for count in plan:
                h = 1 << (bit - 1)
                def one():
                    return nkern.fr_pass(y, t["words"]["fwd"], h, count, True)
                ms, got = _cuda_ms(one, r)
                pms, want = _host_ms(lambda: domain.pass_plain(
                    y, t["words"]["fwd"], h, count, True))
                rows[f"forward pass h=2^{bit - 1} x {count} 2^{lg}"] = \
                    _fr_row(ms, got, want, f"one pass of {count} stages from "
                            f"h=2^{bit - 1}, n=2^{lg}, P=1",
                            fr_pass_bound(1, lg, h, count, True, clock_hz),
                            pms)
                del got, want
                bit -= count
        del y, b, c
    key = f"forward 2^{log_n}"
    fpass = dict(rows.pop(key), modes=rows)
    n = 1 << log_n
    y = random_mont((P, n), device, seed + 5)
    r2 = torch.as_tensor(ints_to_limbs(FR.r2_mod_p), device=device)
    pms, want = _host_ms(lambda: domain.pointwise_plain(y, r2), 3)
    def mont():
        return nkern.pointwise(y, r2)
    ms, got = _cuda_ms(mont, reps)
    pointwise = _fr_row(ms, got, want, f"times R^2, {P} x 2^{log_n}",
                        fr_pointwise_bound(P * n, clock_hz), pms)
    pointwise["graph_ms"] = _graph_ms(mont, reps)[0]
    return {("fr_pass", FR_ROW): fpass, ("fr_pointwise", FR_ROW): pointwise}


def h_pipeline_plain(evs, tinv, t, demont):
    """The H(X) pipeline on the plain forms (the kernels' twins), one
    polynomial at a time: the bit-reversed gather and ``inverse_plain``,
    the coset powers and ``forward_plain``, the quotient
    (``quotient_plain``), ``inverse_plain`` and the coset inverse powers,
    and the demont step."""
    def on_coset(ev):
        coeffs = domain.inverse_plain(ev[..., t["br"], :], t["inv"],
                                      t["ninv"])
        return domain.forward_plain(FR.mont_mul(coeffs, t["coset"]),
                                    t["fwd"])
    a, b, c = (on_coset(evs[i]) for i in range(3))
    h_ev = domain.quotient_plain(a, b, c, tinv)
    del a, b, c
    h = FR.mont_mul(domain.inverse_plain(h_ev, t["inv"], t["ninv"]),
                    t["coset_inv"])
    return FR.mont_mul(h, t["one"]) if demont else h


# ----------------------------------- phase 15: a domain-2^21 proof

VARIANT = "var_pk_e_witness"
VARIANT_ROWS = 1185473
VARIANT_WIRES = 1187520
VARIANT_DOMAIN = 1 << 21


def variant_prep(out_dir):
    """Phase 15's host work that needs no kernel, done while phase 1's
    compilers run: the auditor key from ``write_rlwe_dir`` under
    ``out_dir``, the var-PK circuit and its R1CS (``build_s``) and
    ``setup`` called directly (``setup_s``; a ~1 GB pickle buys nothing
    within one run)."""
    vb = _load_script(os.path.join("scripts", "torch_benchmark_variants.py"))
    t0 = time.perf_counter()
    a_pk, b_pk = vb.auditor_key(os.path.join(out_dir, "variants"))
    circ = vb.build_variant(VARIANT, a_pk, b_pk)
    t1 = time.perf_counter()
    keys = setup(circ.builder.r1cs())
    return dict(vb=vb, a_pk=a_pk, b_pk=b_pk, circuit=circ, keys=keys,
                build_s=t1 - t0, setup_s=time.perf_counter() - t1)


def phase_variant(device, prep):
    """Phase 15: the var-PK audit circuit at full width through
    ``scripts/torch_benchmark_variants.py``'s ``run_variant`` on
    ``variant_prep``'s circuit and keys (their seconds kept as
    ``build_s`` and ``setup_s``). The launches of K1-K6, P1, P2, P4 and
    P5 are counted over the whole phase. Then, once, ``h_pipeline_check``
    of the split H(X) pipeline at 2^21 (P4 and P5) against its plain twin
    on the card, limb for limb."""
    circ = prep["circuit"]

    def keys(r1cs):                    # the R1CS ``prep`` set up
        assert r1cs.a_rows is circ.builder.a_rows
        return prep["keys"]

    kernels.reset_launches()           # the main path starts here
    pkern.reset_launches()
    nkern.reset_launches()
    t0 = time.perf_counter()
    rec = prep["vb"].run_variant(
        VARIANT, prep["a_pk"], prep["b_pk"], device=device, setup_fn=keys,
        circuit=circ, log=lambda m: log(15, m.strip()))
    rec["launches"] = dict(kernels.LAUNCHES, **pkern.LAUNCHES,
                           **nkern.LAUNCHES)
    rec["phase_s"] = time.perf_counter() - t0   # the main path ends here
    rec.update(build_s=prep["build_s"], setup_s=prep["setup_s"])
    t1 = time.perf_counter()
    rec["h_pipeline"] = h_pipeline_check(device, VARIANT_DOMAIN, seed=1500,
                                         profile=False)
    rec["h_pipeline"]["check_s"] = time.perf_counter() - t1
    rec["checks"] = dict(
        shape=(rec["constraints"], rec["wires"], rec["n_domain"]) == (
            VARIANT_ROWS, VARIANT_WIRES, VARIANT_DOMAIN),
        legs=rec["leg_points"] == dict(a=10 << 17, k=10 << 17, h=16 << 17,
                                       b2=10 << 17),
        verify=rec["verify"] == [True, True, False, False],
        h_pipeline=rec["h_pipeline"]["equal"]
        and rec["h_pipeline"]["sync_free"])
    rec["ok"] = all(rec["checks"].values())
    return rec


def withdraw_shape_r1cs(m=8899, num_public=3, n_inputs=8, seed=2024):
    """Seeded synthetic R1CS of the withdraw proof's shape: ``m`` rows, wire
    0 the constant, wires 1..num_public-1 public outputs, ``n_inputs``
    private inputs, then one wire per row c_i = (lc) * (lc), each lc of at
    most 3 terms over wires computed earlier; the last num_public - 1 rows
    define the public outputs. Returns (r1cs, witness fn(seed))."""
    rng = random.Random(seed)
    npub_out = num_public - 1
    first = num_public + n_inputs               # first computed wire
    nv = first + m - npub_out
    a_rows, b_rows, c_rows = [], [], []

    def lc(avail):
        terms = {}
        for _ in range(rng.randrange(1, 4)):
            terms[rng.choice(avail)] = rng.randrange(1, FR_MOD)
        return terms

    avail = [0] + list(range(num_public, first))
    for i in range(m):
        a_rows.append(lc(avail[-64:] + [0]))
        b_rows.append(lc(avail[-64:] + [0]))
        if i < m - npub_out:
            out = first + i
            avail.append(out)
        else:
            out = 1 + (i - (m - npub_out))      # public output wire
        c_rows.append({out: 1})
    r1cs = R1CS(num_vars=nv, num_public=num_public, a_rows=a_rows,
                b_rows=b_rows, c_rows=c_rows)

    def witness(wseed):
        wr = random.Random(wseed)
        w = [0] * nv
        w[0] = 1
        for i in range(num_public, first):
            w[i] = wr.randrange(FR_MOD)
        for i in range(m):
            v = (r1cs.eval_row(a_rows[i], w) * r1cs.eval_row(b_rows[i], w)
                 % FR_MOD)
            w[next(iter(c_rows[i]))] = v
        assert r1cs.is_satisfied(w)
        return w

    return r1cs, witness


# the kernel functions whose device time profile_prove sums over their
# Fp and Fp2 instantiations
PROFILED = ("k_prefix_rows", "k_prefix", "k_wsum", "k_addn", "k_scale_add",
            "k_horner", "k_tree_level", "k_poseidon", "k_poseidon_lanes")


def profile_prove(run):
    """Trace one warm proof with torch.profiler: device busy share of the
    wall time (kernels of one stream do not overlap, so the summed time of
    the device's own events, kernels and copies, is the busy time), each
    MSM kernel's device ms and launches, and the device events with the
    most time. ``all_rows_s`` sums every row, the torch ops' device time
    too, which repeats their kernels' (an earlier, inflated busy count).
    The card's rows of the prover's spans (``utils.metrics.span``, user
    annotations) are left out of both: a span's row times the work under
    it, which the kernels' and copies' rows already count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, all_us = [], 0
    for e in prof.key_averages():
        if getattr(e, "is_user_annotation", False):
            continue
        dev_us = e.self_device_time_total
        all_us += dev_us
        if dev_us > 0 and e.device_type == DeviceType.CUDA:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    by_kernel = {}            # device ms and launches of each MSM kernel
    for us, k, n in rows:
        for kern in PROFILED:
            if kern + "<" in k:
                ms, cnt = by_kernel.get(kern, (0.0, 0))
                by_kernel[kern] = (ms + us / 1e3, cnt + n)
    return dict(wall_s=wall, device_busy_s=busy_s,
                busy_share=busy_s / wall if wall else None,
                all_rows_s=all_us / 1e6,
                by_kernel={k: dict(device_ms=ms, count=n)
                           for k, (ms, n) in by_kernel.items()},
                top=[dict(name=k[:80], device_ms=us / 1e3, count=n)
                     for us, k, n in rows[:12]])


@contextlib.contextmanager
def _uncounted(counts):
    """Launches inside are checks against a plain version: the counts
    return to what they were."""
    saved = dict(counts)
    try:
        yield
    finally:
        counts.update(saved)


def h_pipeline_check(device, n, seed=60, profile=True):
    """The prover's H(X) pipeline at domain n (``prove._h_pipeline``, or
    ``_h_pipeline_split`` from 2^20, in the prover's demont form: P4 a
    stage of the inverse NTT, the coset forward NTT and the coset inverse
    NTT, P5 the quotient and the demont step) on seeded evaluations, held
    limb for limb to its plain twin on the card (``h_pipeline_plain``) and
    run under ``torch.cuda.set_sync_debug_mode("error")``, which raises at
    any host sync, after one warm call outside it; the host ms of the
    kernel pipeline (synchronized, mean of 3) and of the twin; with
    ``profile``, ``torch.profiler`` over one more call gives the device
    kernels by name and count (P4 and P5 only: no torch arithmetic or
    matmul). These launches are not counted."""
    ev = random_mont((3, n), device, seed)
    tinv = random_mont((), device, seed + 1)
    tables = domain.tables(n, device)
    pipeline = (tp._h_pipeline_split if n >= tp._H_SPLIT_MIN_N
                else tp._h_pipeline)
    with _uncounted(nkern.LAUNCHES):
        plain_ms, want = _host_ms(lambda: h_pipeline_plain(ev, tinv, tables,
                                                           True))
        _host_ms(lambda: pipeline(ev, tinv, tables, True))
        ms, _ = _host_ms(lambda: pipeline(ev, tinv, tables, True), 3)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = pipeline(ev, tinv, tables, True)
            err = None
        except RuntimeError as e:
            got, err = None, str(e).splitlines()[0][:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        info = dict(n=n, sync_free=err is None, sync_error=err,
                    equal=got is not None and torch.equal(got, want),
                    ms=ms, plain_ms=plain_ms)
        del want, got
        if profile:
            _, _, launched, copies = kernel_launches(
                lambda: pipeline(ev, tinv, tables, True))
            info.update(profile={k[:60]: v for k, v in
                                 {**launched, **copies}.items()},
                        only_p4_p5=bool(launched) and all(
                            "k_fr_" in k for k in launched))
    return info


def h_ntt_check(dpk, r1cs, w, runs=4, seed=60):
    """``h_pipeline_check`` at ``dpk``'s domain, then ``runs`` proofs with
    the device synchronized around each phase: the seconds of ``h_ntt``,
    ``h_rows`` (inside ``h_ntt``) and ``upload``."""
    info = h_pipeline_check(dpk.device, dpk.pk.n_domain, seed)
    for i in range(runs):
        ph = {}
        tp.prove(dpk, r1cs, w, seed=seed + 2 + i, timings=ph)
        for k in ("h_ntt", "h_rows", "upload"):
            info.setdefault(k + "_s", []).append(ph[k])
    return info


def phase_prove(device, profile=False):
    info = {}
    t0 = time.perf_counter()
    r1cs, witness = withdraw_shape_r1cs()
    w = witness(1)
    pk, vk = setup(r1cs, seed=31)
    info["setup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dpk = tp.DeviceProvingKey(pk, device=device)
    torch.cuda.synchronize()
    info["dpk_s"] = time.perf_counter() - t0
    info["legs"] = dict(a=dpk._na, k=dpk._nk, h=dpk._nh, b2=dpk._nb2,
                        n=pk.n_domain, rows=len(r1cs.a_rows),
                        vars=r1cs.num_vars)
    pub = w[1:r1cs.num_public]

    kernels.reset_launches()          # the main path starts here
    nkern.reset_launches()
    t0 = time.perf_counter()
    proof = tp.prove(dpk, r1cs, w, seed=7)
    info["cold_s"] = time.perf_counter() - t0
    ok = verify(vk, proof, pub)
    ok &= not verify(vk, proof, [pub[0] + 1] + pub[1:])
    warm, kept = [], [(proof, pub)]
    for i in range(3):
        t0 = time.perf_counter()
        p = tp.prove(dpk, r1cs, w, seed=8 + i)
        warm.append(time.perf_counter() - t0)
        ok &= verify(vk, p, pub)
        kept.append((p, pub))
    per_proof = {k: v // 4 for k, v in dict(kernels.LAUNCHES,
                                            **nkern.LAUNCHES).items()}
    phases = {}          # one more proof, synchronized around each phase
    tp.prove(dpk, r1cs, w, seed=11, timings=phases)
    info["h_ntt"] = h_ntt_check(dpk, r1cs, w)
    if profile:
        info["profile"] = profile_prove(lambda: tp.prove(dpk, r1cs, w,
                                                         seed=12))
    ws = [witness(10 + i) for i in range(4)]
    batch = tp.prove_batch(dpk, r1cs, ws, seed=40)
    singles = [tp.prove(dpk, r1cs, wi, seed=40 + i)
               for i, wi in enumerate(ws)]
    batch_ok = batch == singles and verify(vk, batch[3],
                                           ws[3][1:r1cs.num_public])
    launches = dict(kernels.LAUNCHES,    # the main path ends here
                    **nkern.LAUNCHES)
    info.update(verified=bool(ok), batch_ok=bool(batch_ok),
                warm_s=warm, proofs_per_s=len(warm) / sum(warm),
                phases_s=phases, launches=launches,
                launches_per_proof=per_proof)
    kept += [(p, wi[1:r1cs.num_public]) for p, wi in zip(batch, ws)]
    return info, dict(r1cs=r1cs, w=w, pk=pk, vk=vk, proof=proof, dpk=dpk,
                      witness=witness, proofs=kept)


def ptxas_summary(text, kernels=("k_prefix<", "k_addn<", "k_scale_add<",
                                 "k_horner<", "k_poseidon<",
                                 "k_poseidon_lanes<", "k_tree_level<",
                                 "k_miller_lines", "k_final_exp",
                                 "k_poseidon2<", "k_fr_pass",
                                 "k_fr_pointwise")):
    """{kernel instantiation: registers, spill stores, stack bytes, ptxas
    ms} from ``-Xptxas -v`` output, for the entry functions whose demangled
    name starts with one of ``kernels`` (K2, K4-K8, P1-P5 by default)."""
    import re
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            dem = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                 text=True).stdout.strip()
            name = dem.split("(")[0].replace("zk::", "").removeprefix(
                "void ")
            name = name if name.startswith(kernels) else None
            continue
        if name is None:
            continue
        r = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and "stack" not in r:
            r.update(stack=int(m.group(1)), spill_stores=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            r["registers"] = int(m.group(1))
        m = re.search(r"Compile time = ([\d.]+) ms", line)
        if m:
            r["ptxas_ms"] = float(m.group(1))
            name = None
    return out


def main(argv):
    out_dir = (argv[argv.index("--out") + 1] if "--out" in argv
               else os.path.join(HERE, "chip_smoke_out"))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--pod-worker" in argv:         # one process of phase 14
        i = argv.index("--pod-worker")
        return pod_worker(int(argv[i + 1]), argv[i + 2], argv[i + 3])
    if "--naive-pairing-worker" in argv:   # phase 13 (d), during phase 1
        return naive_pairing_worker()
    os.makedirs(out_dir, exist_ok=True)
    device = torch.device("cuda", 0)

    # ---- 0: card
    card = nvidia_smi("name,power.limit")
    clock_mhz = nvidia_smi("clocks.max.sm").split()[0:1]
    clock_hz = float(clock_mhz[0]) * 1e6 if clock_mhz else 1.98e9
    kind = torch.cuda.get_device_name(0)
    log(0, f"card {card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda} | {kind} | max SM clock {clock_hz / 1e6:.0f}"
           f" MHz")

    # ---- 1: build (one nvcc per kernel source and g++, started together)
    t0 = time.perf_counter()
    flags = ["-Xptxas", "-v"]
    cus = dict(msm=kernels.SOURCE, poseidon=hkern.SOURCE,
               tree=tkern.SOURCE, ntt=ntt_rdma.SOURCE, mul="mul_bench.cu",
               pairing=pkern.SOURCE, poseidon2=p2k.SOURCE,
               fr_ntt=nkern.SOURCE)
    def timed(cu):
        t = time.perf_counter()
        return cuda_build.build(cu, flags) + (time.perf_counter() - t,)

    with ThreadPoolExecutor(len(cus) + 3) as ex:
        futs = {k: ex.submit(timed, cu) for k, cu in cus.items()}
        futs["host"] = ex.submit(native_bridge.get_lib)
        futs["witness"] = ex.submit(solver_native.get_lib)
        naive = ex.submit(naive_pairing_in_worker, out_dir,
                          futs["pairing"])
        futs["host"].result()          # setup's fixed-base products
        t1 = time.perf_counter()
        prep = variant_prep(out_dir)   # phase 15's host work, meanwhile
        prep_s = time.perf_counter() - t1
        built = {k: f.result() for k, f in futs.items()}
        ppio = naive.result()          # done before any phase times
    ptxas = "".join(built[k][1] or "" for k in cus)
    if ptxas:
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            f.write(ptxas)
    for name, r in ptxas_summary(ptxas).items():
        log(1, f"{name}: {r.get('registers')} registers, "
               f"{r.get('spill_stores')} B spill stores, {r.get('stack')} B "
               f"stack, ptxas {r.get('ptxas_ms')} ms")
    log(1, "built " + ", ".join(f"{os.path.basename(built[k][0])} "
                                f"({built[k][2]:.1f} s)" for k in cus)
           + f" in {time.perf_counter() - t0:.1f} s"
           + ("" if ptxas else " (cached)"))
    log(1, f"meanwhile phase 15's circuit ({prep['build_s']:.1f} s) and "
           f"setup ({prep['setup_s']:.1f} s) on the host, {prep_s:.1f} s; "
           f"phase 13's naive pairing in a worker process, "
           f"{ppio['worker_s']:.1f} s")

    # ---- 2: the product microbenchmark, then kernels vs plain twins,
    # small then at the slices' shapes
    products = time_products(device)
    for (ncomp, form), r in products.items():
        log(2, f"product {'Fp' if ncomp == 1 else 'Fp2'} ({r['form']}): "
               f"{r['us']:.4f} us a product, {r['us_step']:.4f} us "
               f"({r['cycles_step']:.0f} cycles) a step, max |err| "
               f"{r['max_abs_err']}")
    if any(r["max_abs_err"] for r in products.values()):
        raise AssertionError("the product forms disagree")
    inverses = time_inverses(device)
    for form, r in inverses.items():
        log(2, f"inverse Fp ({r['form']}): {r['us']:.4f} us "
               f"({r['cycles']:.0f} cycles) a step, max |err| "
               f"{r['max_abs_err']}")
    if any(r["max_abs_err"] for r in inverses.values()):
        raise AssertionError("the inverse or square forms disagree")
    t0 = time.perf_counter()
    errs = check_kernels(device)
    bad = {k: v for k, v in errs.items() if v}
    log(2, f"{len(errs)} kernel modes equal to their plain twins: "
           f"{not bad} ({time.perf_counter() - t0:.1f} s)")
    if bad:
        raise AssertionError(f"kernels differ from plain twins: {bad}")
    times = time_kernels(device, clock_hz, products)
    times.update(time_poseidon(device, clock_hz, products, inverses))
    for (name, c), t in times.items():
        label = (f"t={c}" if name == "poseidon" else "G1" if c == 1
                 else "G2")
        if "smi" in t:
            log(2, f"{name} {label}: clocks.sm, power.draw, temperature.gpu"
                   f" while its CUDA graph replays: {json.dumps(t['smi'])}")
        for u in _timed(t):
            if u:
                floor = (f", chain floor {u['floor_ms']:.4f} ms "
                         f"({u['chain_levels']} product levels)"
                         if "floor_ms" in u else "")
                if "layout" in u:
                    floor += f", layout {u['layout']}"
                if "graph_ms" in u:
                    floor += f", in a CUDA graph {u['graph_ms']:.4f} ms"
                log(2, f"{name} {label} {u['shape']}: "
                       f"max |err| {u['max_abs_err']}, {u['ms']:.4f} ms, "
                       f"plain {u['plain_ms']:.2f} ms, bound "
                       f"{u['bound_ms']:.5f} ms ({u['bound_by']}){floor}")
    widths, width_layouts = time_poseidon_widths(device)
    log(2, "poseidon ms at 32,768 hashes by width t: "
           + json.dumps({t: round(ms, 4) for t, ms in widths.items()}))
    log(2, "poseidon ms by width t in each built layout (a CUDA graph): "
           + json.dumps(width_layouts))
    bad = {k: _times_err(t) for k, t in times.items() if _times_err(t)}
    if bad:
        raise AssertionError(
            f"kernels differ from plain twins at the slices' shapes: {bad}")
    t0 = time.perf_counter()
    ferrs, pass_launches, want_launches = check_fr_ntt(device)
    errs.update(ferrs)
    bad = {k: v for k, v in ferrs.items() if v}
    log(2, f"fr_pass, fr_pointwise: {len(ferrs)} cases equal to their "
           f"plain versions: {not bad}, P4 {pass_launches} launches "
           f"({time.perf_counter() - t0:.1f} s)")
    if bad or pass_launches != want_launches:
        raise AssertionError(f"P4 or P5 differs from its plain version, or "
                             f"P4 launched other than once a pass: {bad}, "
                             f"{pass_launches} launches, {want_launches} "
                             f"passes")
    ftimes = time_fr_ntt(device, clock_hz)
    times.update(ftimes)
    for (name, _), t in ftimes.items():
        for u in _timed(t):
            graph = (f", in a CUDA graph {u['graph_ms']:.5f} ms"
                     if "graph_ms" in u else "")
            log(2, f"{name} {u['shape']}: max |err| {u['max_abs_err']}, "
                   f"{u['ms']:.4f} ms{graph}, plain {u['plain_ms']:.2f} ms, "
                   f"bound {u['bound_ms']:.5f} ms ({u['bound_by']})")
    if any(_times_err(t) for t in ftimes.values()):
        raise AssertionError("P4 or P5 differs from its plain version at "
                             "the prover's shapes")

    # ---- 3: MSMs against the native oracle
    msm, g1 = phase_msm(device)
    log(3, "msm " + json.dumps(msm))
    if not all(v["ok"] for v in msm.values()):
        raise AssertionError("MSM differs from the native oracle")

    # ---- 4: prove at withdraw scale
    info, ctx = phase_prove(device, profile="--profile" in argv)
    log(4, "prove " + json.dumps(info))
    if not (info["verified"] and info["batch_ok"]):
        raise AssertionError("proof check failed")
    if not (info["h_ntt"]["sync_free"] and info["h_ntt"]["equal"]
            and info["h_ntt"]["only_p4_p5"]):
        raise AssertionError(f"the H(X) pipeline synced the host, differs "
                             f"from its plain twin or ran other kernels "
                             f"than P4 and P5: {info['h_ntt']}")
    # three transforms of pass_plan's passes, and P5's R^2 step, a proof
    h_launches = dict(fr_pass=3 * len(domain.pass_plan(
        info["legs"]["n"].bit_length() - 1, nkern.max_pass(device))),
        fr_pointwise=1)
    if any(info["launches_per_proof"][k] != v for k, v in h_launches.items()):
        raise AssertionError(f"P4 / P5 launches a proof other than "
                             f"{h_launches}: {info['launches_per_proof']}")

    # ---- 6: the depth-16 Merkle tree through K7
    merkle = phase_merkle(device, clock_hz, products, inverses,
                          profile="--profile" in argv)
    log(6, "merkle " + json.dumps(merkle))
    if not merkle["ok"]:
        raise AssertionError("Merkle tree check failed")

    # ---- 7: hash2 chain throughput
    chain = phase_chain(device, clock_hz)
    log(7, "chain " + json.dumps(chain))
    if not chain["ok"]:
        raise AssertionError("hash chain differs from the host oracle")

    # ---- 8: the affine bucket tree through K8
    t = times[("tree_level", 1)] = time_tree(device, clock_hz, products,
                                             inverses)
    log(8, f"tree_level G1 {t['shape']} {t['launch_shape']}: max |err| "
           f"{t['max_abs_err']}, {t['ms']:.4f} ms, plain "
           f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.5f} ms "
           f"({t['bound_by']}), chain floor {t['floor_ms']:.4f} ms (the "
           f"inverse and {t['chain_levels']} product levels); per level ms "
           + json.dumps(t["level_ms"]) + ", in a CUDA graph " + json.dumps(
               t["level_graph_ms"]) + ", bound " + json.dumps(
               t["level_bound_ms"]) + ", floor " + json.dumps(
               t["level_floor_ms"]))
    if t["max_abs_err"]:
        raise AssertionError("K8 differs from its plain twin at level 0")
    tree = phase_tree(device, g1, ctx, profile="--profile" in argv)
    log(8, "tree " + json.dumps(tree))
    if not tree["ok"]:
        raise AssertionError("tree=True MSM or proof check failed")

    # ---- 9: the sharded paths on D virtual shards of this one card
    log(9, f"mesh: every shard on {device}, virtual (torch.cuda."
           f"device_count() = {torch.cuda.device_count()}); copies between "
           f"shards are device-to-device copies on one card")
    t0 = time.perf_counter()
    xerrs, xlaunches = check_exchange(device)
    errs.update(xerrs)
    bad = {k: v for k, v in xerrs.items() if v}
    log(9, f"exchange_butterfly: {len(xerrs)} cases equal to the twin: "
           f"{not bad}, {xlaunches} launches "
           f"({time.perf_counter() - t0:.1f} s)")
    if bad or xlaunches != len(xerrs):
        raise AssertionError(f"K9 differs from its twin or launched other "
                             f"than once a case: {bad}, {xlaunches} launches")
    t = times[("exchange_butterfly", 8)] = time_exchange(device, clock_hz)
    log(9, f"exchange_butterfly, a forward stage over {t['D']} slots "
           f"{t['shape']}, one launch: max |err| {t['max_abs_err']}, "
           f"{t['ms']:.4f} ms (in a CUDA graph {t['graph_ms']:.4f} ms, the "
           f"inverse form {t['inverse_graph_ms']:.4f} ms; from device "
           f"memory, four input sets in turn, {t['cold_graph_ms']:.4f} ms), "
           f"plain "
           f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
           f"({t['bound_by']}; {t['bound_copies_ms']:.5f} ms with the "
           f"partners' shards as separate copies); through the mesh, host "
           f"clock: rdma {t['stage_rdma_ms']:.4f} ms, ppermute "
           f"{t['stage_ppermute_ms']:.4f} ms")
    if t["max_abs_err"]:
        raise AssertionError("K9 differs from its twin at phase 9's shape")
    mesh_ntt = phase_ntt(device)
    log(9, "ntt " + json.dumps(mesh_ntt))
    if not mesh_ntt["ok"]:
        raise AssertionError("the sharded NTT differs from the single-device "
                             "NTT or the schoolbook, or ran K9 other than "
                             "3 log2(D) times a product")
    mesh_msm, mesh_points = phase_msm_sharded(device, g1)
    log(9, "msm " + json.dumps(mesh_msm))
    if not all(v["ok"] for v in mesh_msm.values()):
        raise AssertionError("a sharded MSM differs from the native oracle")
    legs = phase_legs(device, g1)
    log(9, "legs " + json.dumps(legs))
    if not legs["ok"]:
        raise AssertionError("a leg-parallel MSM differs from the oracle")
    dp = phase_dp_step(device)
    log(9, "dp-step " + json.dumps(dp))
    if not dp["ok"]:
        raise AssertionError("the dp-sharded Merkle root differs from "
                             "build_levels")

    # ---- 10: the batched Groth16 verify through P1 and P2
    log(10, "lane programs' first use " + json.dumps(time_programs(device)))
    t0 = time.perf_counter()
    perrs, plain_ms, (g3, l3) = check_pairing(device)
    errs.update({(k[0], 0, k[1]): v for k, v in perrs.items()})
    bad = {k: v for k, v in perrs.items() if v}
    log(10, f"{len(perrs)} pairing kernel modes equal to their plain "
            f"versions: {not bad} ({time.perf_counter() - t0:.1f} s; the "
            f"plain versions at B = 256: Miller loop "
            f"{plain_ms['miller_lines']:.0f} ms, final exponentiation "
            f"{plain_ms['final_exp']:.0f} ms)")
    if bad:
        raise AssertionError(f"P1 or P2 differs from its plain version: "
                             f"{bad}")
    for name, t in time_pairing(device, clock_hz, products, inverses, g3, l3,
                                plain_ms).items():
        times[(name, 256)] = t
        log(10, f"{name} {t['shape']}: {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.5f} ms "
                f"({t['bound_by']}; {t['fp_products']} Fp products an "
                f"element), chain floor {t['floor_ms']:.4f} ms "
                f"({t['chain_levels']} product levels)")
    del g3, l3
    ver = phase_verify(device, ctx)
    log(10, "verify " + json.dumps(ver))
    if not ver["ok"]:
        raise AssertionError("the batched verify accepted a bad proof, "
                             "rejected a good one or differs from refimpl")

    # ---- 11: the audit path: P3, RLWE, Shamir, the committed audit proof
    t0 = time.perf_counter()
    p3_sponge = {}
    p3errs, p3_perm_ms = check_poseidon2(device, keep=p3_sponge)
    errs.update(p3errs)
    bad = {k: v for k, v in p3errs.items() if v}
    log(11, f"{len(p3errs)} poseidon2 modes equal to the plain version: "
            f"{not bad} ({time.perf_counter() - t0:.1f} s; the plain "
            f"permutation at B = {max(P3_BS)}: {p3_perm_ms:.0f} ms)")
    if bad:
        raise AssertionError(f"P3 differs from its plain version: {bad}")
    t = times[("poseidon2", P3_ROW)] = time_poseidon2(
        device, clock_hz, products, p3_sponge)
    log(11, f"the need for P3: the plain ct_commitment {t['shape']} "
            f"{t['plain_ms']:.0f} ms on the card ({t['plain_fieldctx_calls']}"
            f" FieldCtx calls a sponge, {t['plain_permutation_launches']} "
            f"device launches a permutation), P3 {t['ms']:.4f} ms, max "
            f"|err| {t['max_abs_err']}")
    for u in t["by_batch"].values():
        log(11, f"poseidon2 {u['shape']}: {u['ms']:.4f} ms, bound "
                f"{u['bound_ms']:.5f} ms ({u['bound_by']}), chain floor "
                f"{u['floor_ms']:.4f} ms ({u['chain_levels']} product "
                f"levels)")
    audit_proofs = {}
    audit = phase_audit(device, keep=audit_proofs)
    audit["phase_s"] = time.perf_counter() - t0
    log(11, "audit " + json.dumps(audit, default=str))
    if not audit["ok"]:
        raise AssertionError(f"the audit path failed: {audit['checks']}")

    # ---- 12: the pool: A8 on the card, the journey over HTTP, the wire
    # format on real proofs
    t0 = time.perf_counter()
    curves = pool_curves(device)
    log(12, "curves " + json.dumps(curves))
    if not curves["ok"]:
        raise AssertionError(f"A8 differs from the host oracles: "
                             f"{curves['checks']}")
    journey = pool_journey(device, out_dir)
    log(12, "journey " + json.dumps(journey))
    sized = pool_at_size(device, out_dir)
    log(12, "at size " + json.dumps(sized))
    pkern.reset_launches()            # the main path starts here
    wire = pool_wire(device, out_dir, ctx, audit_proofs)
    pool_launches = dict(             # K7 from the requests of each app
        poseidon=journey["k7_launches"] + sized["k7_launches"],
        **pkern.LAUNCHES)             # the main path ends here
    wire["phase_s"] = time.perf_counter() - t0
    log(12, "wire " + json.dumps(wire))
    if not (journey["ok"] and sized["ok"] and wire["ok"]):
        raise AssertionError(f"the pool failed: {journey['checks']}, "
                             f"{sized['checks']}, {wire['checks']}")

    # ---- 13: the withdraw proof from an ACIR program: solved natively,
    # proved through K1-K6, verified through P1 and P2, over HTTP
    withdraw = phase_withdraw(device, out_dir, ppio)
    log(13, f"phase {withdraw['phase_s']:.1f} s, ok {withdraw['ok']}")
    if not withdraw["ok"]:
        raise AssertionError(
            f"the withdraw path failed: {withdraw['program']['checks']}, "
            f"{withdraw['app']['checks']}, "
            f"{withdraw['naive_pairing']['checks']}")

    # ---- 14: the pod path: two processes on the one card, a (host 2,
    # chip 4) pod mesh whose host axis is the process boundary
    t0 = time.perf_counter()
    pod = phase_pod(device, out_dir, g1, mesh_points, merkle, mesh_ntt)
    pod["phase_s"] = time.perf_counter() - t0
    single = mesh_msm["host=2 chip=4"]
    for r in pod["ranks"]:
        log(14, f"rank {r['rank']} (slots {r['slots']}): init_process_group"
                f" {r['init_s']:.3f} s; 2^18 pod MSM cold "
                f"{r['msm_cold_ms']:.1f} ms, warm {r['msm_warm_ms']:.1f} ms "
                f"(phase 9 in one process: cold {single['cold_ms']:.1f}, "
                f"warm {single['warm_ms']:.1f} ms); cross-process gather "
                f"{json.dumps(r['gather_ms'])} ms; 2^16 root cold "
                f"{r['root_cold_ms']:.1f}, warm {r['root_warm_ms']:.1f} ms; "
                f"launches {json.dumps(r['launches'])}; checks "
                f"{json.dumps(r['checks'])}")
        log_pod_ntt(r)
    log(14, f"pod: two workers in {pod['wall_s']:.1f} s, phase "
            f"{pod['phase_s']:.1f} s, ok {pod['ok']}")
    if not pod["ok"]:
        raise AssertionError(f"the pod path failed: {pod['ranks']}")

    # ---- 15: the var-PK audit circuit at full width, domain 2^21
    variant = phase_variant(device, prep)
    del prep
    steps = ("build_s", "witness_s", "check_s", "setup_s",
             "device_pk_upload_s", "tables_s", "prove_device_cold_s",
             "prove_device_warm_s", "verify_s")
    log(15, f"{VARIANT}: {variant['constraints']} rows, {variant['wires']} "
            f"wires, domain {variant['n_domain']}, legs "
            f"{json.dumps(variant['leg_points'])}; s " + json.dumps(
                {k: round(variant[k], 3) for k in steps}))
    for k in ("prove_phases_cold", "prove_phases_warm"):
        log(15, f"{k} s " + json.dumps(
            {p: round(v, 4) for p, v in variant[k].items()}))
    log(15, f"peak device memory {variant['peak_device_gb']:.2f} GiB "
            f"across the proofs, host RSS {variant['host_rss_gb']:.2f} GiB; "
            f"launches a proof {json.dumps(variant['launches_per_proof'])}, "
            f"in the verify {json.dumps(variant['verify_launches'])}, over "
            f"the phase {json.dumps(variant['launches'])}; verify "
            f"{variant['verify']}; phase {variant['phase_s']:.1f} s, checks "
            f"{json.dumps(variant['checks'])}")
    log(15, "the 2^21 H(X) pipeline against its plain twin " + json.dumps(
        variant["h_pipeline"]))
    if not variant["ok"]:
        raise AssertionError(f"the var-PK proof failed: {variant['checks']}")

    # ---- 5: launches of each main path (prove: K1-K6, Merkle: K7,
    # tree proofs: K8, the sharded NTT's rdma products: K9, the verify:
    # P1 and P2; the audit path: K1-K7, P1, P2 and P3; the withdrawals
    # over HTTP: K1-K7, P1 and P2; the var-PK proofs: K1-K6, P1 and P2)
    launches = dict(info["launches"], poseidon=merkle["launches"],
                    tree_level=tree["launches"],
                    exchange_butterfly=mesh_ntt["rdma_launches"],
                    **ver["launches"],
                    poseidon2=audit["launches"]["poseidon2"])
    wd_launches = withdraw["app"]["launches"]
    missing = [k for k, v in launches.items() if v <= 0] + [
        f"audit {k}" for k, v in audit["launches"].items() if v <= 0] + [
        f"pool {k}" for k, v in pool_launches.items() if v <= 0] + [
        f"withdraw {k}" for k, v in wd_launches.items() if v <= 0] + [
        f"variant {k}" for k, v in variant["launches"].items() if v <= 0]
    log(5, f"launches {json.dumps(launches)}; a withdraw-shape proof "
           f"(phase 4) {json.dumps(info['launches_per_proof'])}; the audit "
           f"path (phase 11) {json.dumps(audit['launches'])}; the pool "
           f"(phase 12) {json.dumps(pool_launches)}; the withdrawals over "
           f"HTTP (phase 13) {json.dumps(wd_launches)}; the var-PK proofs "
           f"(phase 15) {json.dumps(variant['launches'])}")
    if missing:
        raise AssertionError(f"kernels never launched: {missing}")

    log(5, "s from the start to each phase's last line " + json.dumps(
        {k: v for k, v in _WALL.items() if k != "start"}))

    max_err = {}              # over every check, Fp and Fp2, every t
    for (name, _, _), e in errs.items():
        max_err[name] = max(max_err.get(name, 0), e)
    for (name, _), t in times.items():
        max_err[name] = max(max_err[name], _times_err(t))
    max_err["poseidon"] = max(max_err["poseidon"], merkle["max_abs_err"])
    # the row of each kernel: G1 for K1-K6, hash2 (the Merkle tree's width)
    # for K7, the prover's level 0 for K8, a whole stage at D = 8 for K9,
    # the verify's batch of 256 for P1 and P2, the withdraw proof's domain
    # 2^14 for P4 and P5
    row_key = {"poseidon": 3, "exchange_butterfly": 8, "miller_lines": 256,
               "final_exp": 256, "poseidon2": P3_ROW, "fr_pass": FR_ROW,
               "fr_pointwise": FR_ROW}
    rows = {name: times[(name, row_key.get(name, 1))] for name in REPLACES}
    line = {"kernels": [dict(
        name=name, route="cuda", source=SOURCES[name],
        replaces=REPLACES[name], launches=launches[name],
        max_abs_err=max_err[name], ms=rows[name]["ms"],
        plain_ms=rows[name]["plain_ms"], bound_ms=rows[name]["bound_ms"],
        bound_by=rows[name]["bound_by"], library_ms=None)
        for name in REPLACES]}
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, kernels=line["kernels"], times={
            f"{k[0]}/{k[1]}": v for k, v in times.items()}, msm=msm,
            prove=info, merkle=merkle, chain=chain, tree=tree,
            mesh=dict(ntt=mesh_ntt, msm=mesh_msm, legs=legs, dp_step=dp),
            verify=ver, audit=audit, pod=pod, pool=dict(
                curves=curves, journey=journey, at_size=sized, wire=wire,
                launches=pool_launches), withdraw=withdraw, variant=variant),
            f, indent=1, default=str)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
