"""Fit loss and image metric (counterpart of dip_tpu/ops/losses.py's `mse`
and `psnr`)."""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred - target
    return torch.mean(d * d)


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, as a 0-d tensor on pred's device."""
    err = mse(pred, target)
    return 10.0 * torch.log10((data_range * data_range) / torch.clamp(err, min=1e-12))
