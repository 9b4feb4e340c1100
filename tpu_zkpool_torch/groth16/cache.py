"""Setup-artifact caching keyed by circuit hash.

The port's copy of ``tpu_zkpool/groth16/cache.py``: ``circuit_hash`` is the
same byte for byte (the same R1CS gives the same key); the pickles hold the
port's ``refimpl.groth16_ref`` keys and live in a directory of their own,
since a JAX package pickle names that package's classes.

Mirrors the reference's skip-if-exists pipeline checkpointing
(``noir_circuit/prove_linux.sh:66-79`` skips ``sunspot compile``/``setup``
when ``.ccs``/``.pk``/``.vk`` are present) and the client's IndexedDB
persistence (``demo-frontend/app/lib/storage.ts``; SURVEY.md §5
checkpoint/resume): Groth16 proving/verifying keys are serialized under a
hash of the exact constraint system + setup parameters, so re-running an
example pays the ~40 s audit setup once per circuit.
"""

from __future__ import annotations

import hashlib
import os
import pickle

from tpu_zkpool_torch.refimpl.groth16_ref import R1CS, setup

_DEFAULT_DIR = os.path.expanduser("~/.cache/tpu_zkpool_torch_artifacts")


def circuit_hash(r1cs: R1CS, seed: int = 1337, committed=()) -> str:
    """Stable hash of the constraint system + setup parameters."""
    h = hashlib.sha256()
    h.update(f"{r1cs.num_vars}|{r1cs.num_public}|{seed}|"
             f"{tuple(sorted(committed))}".encode())
    for rows in (r1cs.a_rows, r1cs.b_rows, r1cs.c_rows):
        for row in rows:
            for v in sorted(row):
                h.update(v.to_bytes(4, "little"))
                h.update((row[v] % (1 << 256)).to_bytes(32, "little"))
            h.update(b";")
        h.update(b"|")
    return h.hexdigest()


def cached_setup(r1cs: R1CS, seed: int = 1337, committed=(),
                 cache_dir: str = _DEFAULT_DIR, verbose: bool = False):
    """setup() with on-disk pk/vk caching keyed by circuit_hash."""
    key = circuit_hash(r1cs, seed, committed)
    path = os.path.join(cache_dir, f"groth16_{key[:32]}.pkl")
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                pk, vk = pickle.load(f)
            if verbose:
                print(f"[cache] loaded pk/vk from {path}")
            return pk, vk
        except Exception:
            pass  # corrupt cache -> regenerate
    pk, vk = setup(r1cs, seed=seed, committed=committed)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump((pk, vk), f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    if verbose:
        print(f"[cache] saved pk/vk to {path}")
    return pk, vk
