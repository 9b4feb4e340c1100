"""RLWE ring arithmetic mod q = 167772161 (torch).

- ``ntt``: the negacyclic NTT (psi-twist, DIF forward, DIT inverse) and the
  negacyclic product, batched over leading axes.
- ``encrypt``: batched keygen / encrypt / decrypt, bit-exact with
  ``refimpl.rlwe_ref``, and the auditor's Fr -> mod-q map.
- ``quotient``: the audit circuit's integer quotient witnesses.
"""
