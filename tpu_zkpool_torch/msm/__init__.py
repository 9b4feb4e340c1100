"""Grid-accumulator Pippenger MSM over G1 and G2 (CUDA kernels K1-K6)."""

from tpu_zkpool_torch.msm.grid import msm_grid_g1, msm_grid_g2, signed_digits

__all__ = ["msm_grid_g1", "msm_grid_g2", "signed_digits"]
