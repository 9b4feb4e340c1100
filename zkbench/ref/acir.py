"""The ACIR program structures (bincode serialization of Noir's ACIR).

Frozen for the benchmark's reference (``zkbench/ref``): it imports nothing
of the port, and later changes to the port do not reach it.

The dataclasses and the black-box variant order of the port's
``groth16/acir.py``, which ``withdraw_acir`` writes a program from and
``r1cs.convert`` reads; the parser stays with the port.
"""

from __future__ import annotations

from dataclasses import dataclass

@dataclass
class Expression:
    """q_c + sum(c*w) + sum(c*w1*w2) (an ACIR AssertZero / operand expression)."""

    mul_terms: list  # [(coeff, w1, w2)]
    linear: list     # [(coeff, w)]
    q_c: int


@dataclass
class Opcode:
    kind: str
    data: dict


@dataclass
class Circuit:
    name: str
    current_witness_index: int
    opcodes: list
    expression_width: object
    private_parameters: list
    public_parameters: list
    return_values: list
    assert_messages_raw: object = None


@dataclass
class Program:
    circuits: list
    brillig: list  # raw (unparsed bodies)


# BlackBox function variant order in this artifact's ACIR version. Only the
# ones that actually occur in the reference artifacts are mapped; others raise
# so we notice immediately.
_BLACKBOX = {
    0: "aes128_encrypt",
    1: "and",
    2: "xor",
    3: "range",
    4: "blake2s",
    5: "blake3",
    6: "ecdsa_secp256k1",
    7: "ecdsa_secp256r1",
    8: "multi_scalar_mul",
    9: "embedded_curve_add",
    10: "keccakf1600",
    11: "recursive_aggregation",
    12: "bigint_add",
    13: "bigint_sub",
    14: "bigint_mul",
    15: "bigint_div",
    16: "bigint_from_le_bytes",
    17: "bigint_to_le_bytes",
    18: "poseidon2_permutation",
    19: "sha256_compression",
}
