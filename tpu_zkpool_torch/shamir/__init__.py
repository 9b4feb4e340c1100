"""Shamir 2-of-3 sharing over BN254 Fr, batched (``shamir.shamir``)."""

from tpu_zkpool_torch.shamir.shamir import reconstruct_batch, share_batch

__all__ = ["share_batch", "reconstruct_batch"]
