"""BN254 curve / field constants.

Frozen for the benchmark's reference (``zkbench/ref``): it imports nothing
of the port, and later changes to the port do not reach it.

These are mathematical constants of the BN254 (alt_bn128) curve, matching the
values used throughout the reference repo:

- ``FR_MOD``: the scalar field modulus p used for all circuit arithmetic
  (reference ``scripts/generate_audit.py:34``, ``client/merkle.ts:47``).
- ``FP_MOD``: the base field modulus (order of the embedded "BabyJubJub-style"
  short-Weierstrass curve's scalar group, reference ``client/merkle.ts:48``).
- Embedded curve (called BabyJubJub in the reference but actually the
  Grumpkin-style curve y^2 = x^3 - 17 over Fr): generator at
  ``client/merkle.ts:57-58``.
"""

# BN254 scalar field modulus (a.k.a. Fr; the Noir/circom "Field").
FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN254 base field modulus (a.k.a. Fp / Fq).
FP_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Embedded curve ("BabyJubJub" in the reference, short-Weierstrass
# y^2 = x^3 + A x + B over Fr with A = 0, B = -17).
EMBEDDED_A = 0
EMBEDDED_B = FR_MOD - 17
EMBEDDED_GX = 1
EMBEDDED_GY = 17631683881184975370165255887551781615748388533673675138860
# Group order of the embedded curve = FP_MOD (the two curves form a cycle).
EMBEDDED_ORDER = FP_MOD

# BN254 G1 generator (for Groth16 / pairings; standard alt_bn128 generator).
G1_GX = 1
G1_GY = 2

# BN254 G2 generator over Fp2 = Fp[u]/(u^2 + 1), coordinates (x0 + x1 u, y0 + y1 u).
G2_GX = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GY = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# BN curve parameter x (seed) for alt_bn128: p(x), r(x) per the BN family.
BN_X = 4965661367192848881
