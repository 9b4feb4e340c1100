"""Poseidon hashing over BN254 Fr (CUDA kernel K7 and its plain twin).

- ``poseidon_params``: the port's copy of the Grain-LFSR generation of the
  circomlib Poseidon constants, and the pure-Python oracle.
- ``poseidon``: batched permutation and hash2/hash3/hash4 in torch, the
  weights (``load_tables``), and the plain twin of K7.
- ``kernels``: the ctypes wrapper of K7 (``csrc/poseidon.cu``).
"""
