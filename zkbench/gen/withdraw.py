"""The withdraw requests of a relayer's queue: notes of a full pool's tree,
each with its path, the nullifier and the owner's commitment, as the ACIR
inputs of the withdraw program (public 0-4: root, nullifier, recipient,
amount, wa_commitment; then sk, owner_x, owner_y, randomness, index and
the siblings).

The pool is the configuration's: ``2^depth`` leaves from ``pool_seed``, of
which ``owned_notes`` are notes whose secrets the benchmark holds and the
rest other users' commitments (uniform field elements). Its tree takes
some 2^depth Poseidon hashes in Python, so it is built once a checkout and
kept in the cache directory. The requests are drawn from ``--seed``: which
owned notes, and the recipients.
"""

from __future__ import annotations

import os
import random

import numpy as np

from zkbench.ref import curve
from zkbench.ref.bn254 import FR_MOD as R
from zkbench.ref.poseidon_params import poseidon_hash_ref as H


def _to_bytes(vals) -> np.ndarray:
    return np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                         dtype=np.uint8).reshape(-1, 32)


def _to_ints(arr: np.ndarray) -> list:
    return [int.from_bytes(row.tobytes(), "little") for row in arr]


def _build_pool(depth: int, pool_seed: int, owned: int) -> dict:
    rng = random.Random(pool_seed)
    n = 1 << depth
    index = sorted(rng.sample(range(n), owned))
    sk = [rng.getrandbits(128) for _ in index]
    amount = [rng.randrange(1, 1 << 40) for _ in index]
    rnd = [rng.getrandbits(200) for _ in index]
    owner = [curve.scalar_mul(k) for k in sk]
    leaves = [rng.randrange(R) for _ in range(n)]
    for i, (x, y), a, t in zip(index, owner, amount, rnd):
        leaves[i] = H([x, y, a, t])
    levels = [leaves]
    while len(levels[-1]) > 1:
        lv = levels[-1]
        levels.append([H([lv[2 * i], lv[2 * i + 1]])
                       for i in range(len(lv) // 2)])
    return {"index": index, "sk": sk, "amount": amount, "rnd": rnd,
            "owner_x": [p[0] for p in owner], "owner_y": [p[1] for p in owner],
            "levels": levels}


def pool(cfg: dict, cache_dir: str) -> dict:
    """The configuration's pool, from the cache directory or built there."""
    depth, seed, owned = cfg["depth"], cfg["pool_seed"], cfg["owned_notes"]
    path = os.path.join(cache_dir, f"pool_d{depth}_{seed}_{owned}.npz")
    if os.path.exists(path):
        z = np.load(path)
        levels, start = [], 0
        flat = _to_ints(z["nodes"])
        for k in range(depth + 1):
            size = 1 << (depth - k)
            levels.append(flat[start:start + size])
            start += size
        notes = {key: _to_ints(z[key]) for key in
                 ("index", "sk", "amount", "rnd", "owner_x", "owner_y")}
        return {**notes, "levels": levels}
    p = _build_pool(depth, seed, owned)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, nodes=_to_bytes([v for lv in p["levels"] for v in lv]),
             **{key: _to_bytes(p[key]) for key in
                ("index", "sk", "amount", "rnd", "owner_x", "owner_y")})
    os.replace(tmp, path)
    return p


def requests(cfg: dict, count: int, seed: int, cache_dir: str) -> list:
    """``count`` withdrawals of distinct notes drawn from ``seed``, each
    the ACIR input map {witness index: value}."""
    p = pool(cfg, cache_dir)
    depth = cfg["depth"]
    levels = p["levels"]
    root = levels[depth][0]
    rng = random.Random(seed)
    out = []
    for j in rng.sample(range(len(p["index"])), count):
        idx, sk = p["index"][j], p["sk"][j]
        ox, oy = p["owner_x"][j], p["owner_y"][j]
        sibs = [levels[k][(idx >> k) ^ 1] for k in range(depth)]
        vals = [root, H([sk, idx]), rng.randrange(R), p["amount"][j],
                H([ox, oy]), sk, ox, oy, p["rnd"][j], idx] + sibs
        out.append(dict(enumerate(vals)))
    return out


def publics(request: dict) -> list:
    """The five public inputs of a request, in the statement's order."""
    return [request[i] for i in range(5)]


def make(cfg: dict, traffic: dict, seed: int, cache_dir: str) -> list:
    """The requests a run makes in set-up: ``traffic["distinct"]``."""
    return requests(cfg, int(traffic["distinct"]), seed, cache_dir)
