"""BN254 Fr / Fp Montgomery arithmetic on int64 16-bit limbs (torch)."""

from tpu_zkpool_torch.fields.bn254 import FR_MOD, FP_MOD
from tpu_zkpool_torch.fields.fctx import FieldCtx, FR, FP
from tpu_zkpool_torch.fields import limbs

__all__ = ["FR_MOD", "FP_MOD", "FieldCtx", "FR", "FP", "limbs"]
