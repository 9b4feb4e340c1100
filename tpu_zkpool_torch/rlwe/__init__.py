"""RLWE ring arithmetic mod q = 167772161 (torch).

- ``ntt``: the negacyclic NTT (psi-twist, DIF forward, DIT inverse) and the
  negacyclic product, batched over leading axes.
"""
