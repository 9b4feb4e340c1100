"""Pure-Python RLWE ring constants and the schoolbook negacyclic product.

A partial copy of ``tpu_zkpool/refimpl/rlwe_ref.py`` (l.18-44): the audit
ring's size and modulus, and the O(n^2) product that the NTT is held to.
"""

from __future__ import annotations

N = 1024
RLWE_Q = 167772161  # 40 * 2^22 + 1


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
