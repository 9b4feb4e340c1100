"""Typed configuration for fields, RLWE parameters and mesh shape
(SURVEY.md §5 "Config / flag system").

The port of ``tpu_zkpool/config.py``. The reference scatters these as
module-top constants with env-var fallbacks (``scripts/generate_audit.py:
24-34``, ``demo-frontend/app/lib/shielded-pool.ts:4-19``); here one frozen
dataclass tree owns them, loadable from TOML. ``validate()`` cross-checks
the derived quantities (Delta = q // t, NTT-friendliness of q, packing
geometry) so a bad override fails loudly at load time.

The JAX package's ``[kernel]`` table has no counterpart: its
``msm_backend``, ``msm_limb15``, ``poseidon_tile_lanes`` and
``compile_cache`` select Pallas or XLA forms and the JAX compile cache, and
nothing reads its ``msm_window_bits`` (the port's prover and MSMs take their
window width as an argument). A TOML with a ``[kernel]`` table, or any
table but ``[rlwe]`` and ``[mesh]``, fails as unknown.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field

from tpu_zkpool_torch.fields import bn254


@dataclass(frozen=True)
class RlweConfig:
    """BFV/RLWE parameters (reference: scripts/rlwe_keygen.py:18-25,
    generate_audit.py:24-34)."""

    n: int = 1024                  # ring dimension
    q: int = 167772161             # ciphertext modulus (40 * 2^22 + 1)
    t: int = 256                   # plaintext modulus
    noise_bound: int = 3           # coefficients uniform in [-b, b]
    msg_slots: int = 64            # owner_x (32) + owner_y (32) bytes
    pack_bits: int = 32            # bits per packed slot
    pack_width: int = 7            # slots per BN254 field element
    shamir_threshold: int = 2
    shamir_shares: int = 3

    @property
    def delta(self) -> int:        # Delta = floor(q / t)
        return self.q // self.t

    def validate(self) -> None:
        assert self.n & (self.n - 1) == 0, "ring dim must be a power of two"
        # negacyclic NTT needs a 2n-th root of unity mod q
        assert (self.q - 1) % (2 * self.n) == 0, "q not NTT-friendly for 2n"
        assert self.pack_bits * self.pack_width < 254, "packing overflows Fr"
        assert 2 <= self.shamir_threshold <= self.shamir_shares


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout for the sharded paths (SURVEY.md §2.4)."""

    shape: tuple = (1,)
    axis_names: tuple = ("dp",)

    def validate(self) -> None:
        assert len(self.shape) == len(self.axis_names)
        assert all(s >= 1 for s in self.shape)

    def make(self, device=None):
        """Build the port's ``parallel.Mesh``: one CUDA card a slot when
        no card is named and enough cards exist, else every slot on one
        device (``Mesh.virtual``, with a warning that says so). ``cuda``
        unless the caller names another device; raises without a GPU."""
        import numpy as np
        import torch

        from tpu_zkpool_torch import resolve_device
        from tpu_zkpool_torch.parallel import Mesh

        n = int(np.prod(self.shape))
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None and (
                torch.cuda.device_count() >= n):
            grid = np.empty(n, dtype=object)
            grid[:] = [torch.device("cuda", i) for i in range(n)]
            return Mesh(grid.reshape(self.shape), self.axis_names)
        if dev.type == "cuda":
            warnings.warn(
                f"mesh {self.shape}: {torch.cuda.device_count()} CUDA "
                f"device(s) for {n} slots, so every slot is virtual on "
                f"{dev}", stacklevel=2)
        return Mesh.virtual(self.shape, self.axis_names, device=dev)


@dataclass(frozen=True)
class Config:
    rlwe: RlweConfig = field(default_factory=RlweConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # informational field constants (validated, not overridable)
    fr_mod: int = bn254.FR_MOD
    fp_mod: int = bn254.FP_MOD

    def validate(self) -> "Config":
        self.rlwe.validate()
        self.mesh.validate()
        assert self.fr_mod == bn254.FR_MOD and self.fp_mod == bn254.FP_MOD
        return self

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        """Load overrides from a TOML file with [rlwe]/[mesh] tables;
        unspecified keys keep their defaults, unknown tables and keys
        fail."""
        import tomllib

        with open(path, "rb") as f:
            data = tomllib.load(f)
        unknown = set(data) - {"rlwe", "mesh"}
        assert not unknown, f"unknown Config tables: {unknown}"

        def build(klass, table):
            known = {f.name for f in dataclasses.fields(klass)}
            unknown = set(table) - known
            assert not unknown, f"unknown {klass.__name__} keys: {unknown}"
            fixed = {k: tuple(v) if isinstance(v, list) else v
                     for k, v in table.items()}
            return klass(**fixed)

        return cls(
            rlwe=build(RlweConfig, data.get("rlwe", {})),
            mesh=build(MeshConfig, data.get("mesh", {})),
        ).validate()


_config = Config()


def get_config() -> Config:
    return _config


def set_config(cfg: Config) -> Config:
    global _config
    _config = cfg.validate()
    return _config


def load_config(path: str) -> Config:
    return set_config(Config.from_toml(path))
