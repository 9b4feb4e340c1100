"""Pure-Python RLWE and Shamir reference (host code, the oracles).

Frozen for the benchmark's reference (``zkbench/ref``): it imports nothing
of the port, and later changes to the port do not reach it.

The port's copy of ``tpu_zkpool/refimpl/rlwe_ref.py``, function for
function: the ring constants, the O(n^2) negacyclic product the NTT is held
to, the negacyclic matrix rows the audit circuit embeds, Shamir sharing
over BN254 Fr, and keygen / encrypt / decrypt with the same seeded
``random.Random`` draw order (keygen(42) and encrypt(seed=999) reproduce
the reference's committed key and ciphertext).
"""

from __future__ import annotations

import random

from zkbench.ref.bn254 import FR_MOD as BN254_P

N = 1024
NOISE_BOUND = 3
RLWE_Q = 167772161  # 40 * 2^22 + 1
PLAINTEXT_MOD = 256
DELTA = RLWE_Q // PLAINTEXT_MOD  # 655360
MSG_SLOTS = 64
THRESHOLD = 2
NUM_SHARES = 3
PACK_WIDTH = 7
PACK_BITS = 32


def negacyclic_mul(a, b, n=N, q=RLWE_Q):
    """Schoolbook negacyclic polynomial product mod q (x^n = -1)."""
    result = [0] * n
    for i in range(n):
        ai = a[i]
        if ai == 0:
            continue
        for j in range(n):
            idx = i + j
            v = ai * b[j]
            if idx < n:
                result[idx] = (result[idx] + v) % q
            else:
                result[idx - n] = (result[idx - n] - v) % q
    return result


def negacyclic_matrix_row(poly, k, n=N, q=RLWE_Q):
    """Row k of the negacyclic multiplication matrix of ``poly``."""
    row = [0] * n
    for j in range(n):
        idx = k - j
        row[j] = poly[idx] % q if idx >= 0 else (-poly[idx + n]) % q
    return row


def shamir_share_field(secret, rng, threshold=THRESHOLD, num_shares=NUM_SHARES):
    coeffs = [secret % BN254_P]
    for _ in range(threshold - 1):
        coeffs.append(rng.randint(0, BN254_P - 1))
    shares = []
    for i in range(1, num_shares + 1):
        val, x_pow = 0, 1
        for c in coeffs:
            val = (val + c * x_pow) % BN254_P
            x_pow = (x_pow * i) % BN254_P
        shares.append((i, val))
    return shares


def shamir_reconstruct_field(shares, threshold=THRESHOLD):
    secret = 0
    xs = [s[0] for s in shares[:threshold]]
    ys = [s[1] for s in shares[:threshold]]
    for i in range(threshold):
        num = ys[i]
        for j in range(threshold):
            if i != j:
                num = num * (-xs[j]) % BN254_P
                num = num * pow(xs[i] - xs[j], -1, BN254_P) % BN254_P
        secret = (secret + num) % BN254_P
    return secret


def centered_mod(v, q):
    v = v % q
    return v - q if v > q // 2 else v


def keygen(seed: int = 42):
    """RLWE keygen + Shamir split, same RNG consumption as rlwe_keygen.py.

    Returns dict with sk_signed, a, b, e_signed, shares (3 lists of (x, y)).
    """
    rng = random.Random(seed)
    sk_signed = [rng.randint(-NOISE_BOUND, NOISE_BOUND) for _ in range(N)]
    sk_mod_q = [v % RLWE_Q for v in sk_signed]
    a = [rng.randint(0, RLWE_Q - 1) for _ in range(N)]
    e_signed = [rng.randint(-NOISE_BOUND, NOISE_BOUND) for _ in range(N)]
    e_mod_q = [v % RLWE_Q for v in e_signed]
    a_sk = negacyclic_mul(a, sk_mod_q)
    b = [((-a_sk[i]) + e_mod_q[i]) % RLWE_Q for i in range(N)]

    sk_bn254 = [v % BN254_P for v in sk_signed]
    all_shares = [[] for _ in range(NUM_SHARES)]
    for idx in range(N):
        shares = shamir_share_field(sk_bn254[idx], rng)
        for k in range(NUM_SHARES):
            all_shares[k].append(shares[k])
    return {
        "sk_signed": sk_signed,
        "a": a,
        "b": b,
        "e_signed": e_signed,
        "shares": all_shares,
    }


def encode_field_to_bytes(value, num_bytes=32):
    return [(value >> (8 * i)) & 0xFF for i in range(num_bytes)]


def encrypt(pk_a, pk_b, owner_x, owner_y, seed: int = 999):
    """BFV-style encrypt of (owner_x, owner_y) byte slots; generate_audit.py
    semantics with seed-999 noise. Returns dict with r/e1/e2 (signed),
    c0_sparse, c1, and quotient witnesses k0/k1.
    """
    rng = random.Random(seed)
    msg = encode_field_to_bytes(owner_x) + encode_field_to_bytes(owner_y)

    r_signed = [rng.randint(-NOISE_BOUND, NOISE_BOUND) for _ in range(N)]
    e1_signed = [rng.randint(-NOISE_BOUND, NOISE_BOUND) for _ in range(MSG_SLOTS)]
    e2_signed = [rng.randint(-NOISE_BOUND, NOISE_BOUND) for _ in range(N)]

    r_mod_q = [v % RLWE_Q for v in r_signed]
    br = negacyclic_mul(pk_b, r_mod_q)
    c0_sparse = [
        (br[i] + e1_signed[i] + DELTA * msg[i]) % RLWE_Q for i in range(MSG_SLOTS)
    ]
    ar = negacyclic_mul(pk_a, r_mod_q)
    c1 = [(ar[i] + e2_signed[i]) % RLWE_Q for i in range(N)]

    # quotient witnesses over the integers (signed r)
    k0 = []
    for i in range(MSG_SLOTS):
        row = negacyclic_matrix_row(pk_b, i)
        ip = sum(row[j] * r_signed[j] for j in range(N))
        full = ip + e1_signed[i] + DELTA * msg[i]
        rem = full % RLWE_Q
        assert rem == c0_sparse[i]
        k0.append((full - rem) // RLWE_Q)
    k1 = []
    for i in range(N):
        row = negacyclic_matrix_row(pk_a, i)
        ip = sum(row[j] * r_signed[j] for j in range(N))
        full = ip + e2_signed[i]
        rem = full % RLWE_Q
        assert rem == c1[i]
        k1.append((full - rem) // RLWE_Q)

    return {
        "msg": msg,
        "r_signed": r_signed,
        "e1_signed": e1_signed,
        "e2_signed": e2_signed,
        "c0_sparse": c0_sparse,
        "c1": c1,
        "k0": k0,
        "k1": k1,
    }


def decrypt(sk_mod_q, c0_sparse, c1):
    """(c0 + sk*c1) mod q -> round(centered/DELTA) mod t, per rlwe_decrypt.py."""
    sk_c1 = negacyclic_mul(sk_mod_q, c1)
    msg = []
    for i in range(MSG_SLOTS):
        noisy = centered_mod(c0_sparse[i] + sk_c1[i], RLWE_Q)
        # Python round() (banker's rounding) — matches rlwe_decrypt.py:112.
        msg.append(round(noisy / DELTA) % PLAINTEXT_MOD)
    return msg


def decode_bytes(msg):
    x = sum((msg[i] & 0xFF) << (8 * i) for i in range(32))
    y = sum((msg[32 + i] & 0xFF) << (8 * i) for i in range(32))
    return x, y


def pack_values(values, pack_width=PACK_WIDTH, pack_bits=PACK_BITS):
    packed = []
    for i in range(0, len(values), pack_width):
        v = 0
        for j, c in enumerate(values[i : i + pack_width]):
            v += c << (j * pack_bits)
        packed.append(v)
    return packed
