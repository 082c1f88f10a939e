"""Colour-space helpers (counterpart of dip_tpu/ops/color.py): float RGB
to full-swing YCbCr (ITU-R BT.601), then Y rescaled to studio swing
[16/255, 235/255], the SR eval protocol's luma."""

from __future__ import annotations

import torch


def rgb_to_ycbcr_y(rgb: torch.Tensor) -> torch.Tensor:
    """Studio-swing luma from (..., H, W, 3) float RGB in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return (y * (235.0 - 16.0) + 16.0) / 255.0


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """Full YCbCr triple: Y to [16,235]/255, Cb/Cr to [16,240]/255."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + 0.5
    cb = (b - y) * 0.564 + 0.5
    y = (y * (235.0 - 16.0) + 16.0) / 255.0
    cb = (cb * (240.0 - 16.0) + 16.0) / 255.0
    cr = (cr * (240.0 - 16.0) + 16.0) / 255.0
    return torch.stack([y, cb, cr], dim=-1)
