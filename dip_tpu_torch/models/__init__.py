"""Generators of the port (the skip net for now)."""

from dip_tpu_torch.models.skip import Skip

__all__ = ["Skip"]
