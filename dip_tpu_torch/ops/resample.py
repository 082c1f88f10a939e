"""Spatial upsampling of NHWC tensors (counterpart of dip_tpu/ops/resample.py's
`upsample`; the downsamplers come with the super-resolution slice)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample(x: torch.Tensor, scale: int = 2, mode: str = "nearest") -> torch.Tensor:
    """'nearest' duplicates pixels; 'bilinear' uses half-pixel centres
    (`align_corners=False`), the resize the JAX package implements."""
    if mode == "nearest":
        y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale, mode="nearest")
    elif mode == "bilinear":
        y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                          mode="bilinear", align_corners=False)
    else:
        raise ValueError(f"unknown upsample mode {mode!r}")
    return y.permute(0, 2, 3, 1)
