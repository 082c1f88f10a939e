"""Fit losses and image metrics (counterpart of dip_tpu/ops/losses.py's
`mse`, `masked_mse`, `tv_loss`, `psnr`, `psnr_y` and `gram_matrix`)."""

from __future__ import annotations

import torch

from dip_tpu_torch.ops.color import rgb_to_ycbcr_y


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred - target
    return torch.mean(d * d)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MSE over the masked pixels, normalised by the total pixel count and
    not by the mask's population, as the reference's
    `mse(out * mask, img * mask)`."""
    d = (pred - target) * mask
    return torch.mean(d * d)


def tv_loss(x: torch.Tensor, beta: float = 0.5) -> torch.Tensor:
    """Total variation of NHWC `x`: sum of ((dh)^2 + (dw)^2)^beta over the
    common valid region."""
    dh = x[:, :, 1:, :] - x[:, :, :-1, :]   # neighbour difference along W
    dw = x[:, 1:, :, :] - x[:, :-1, :, :]   # neighbour difference along H
    return torch.sum((dh[:, :-1] ** 2 + dw[:, :, :-1] ** 2) ** beta)


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, as a 0-d tensor on pred's device."""
    err = mse(pred, target)
    return 10.0 * torch.log10((data_range * data_range) / torch.clamp(err, min=1e-12))


def psnr_y(pred_rgb: torch.Tensor, target_rgb: torch.Tensor, crop: int = 0) -> torch.Tensor:
    """PSNR on the studio-swing Y channel (the paper's SR table metric);
    `crop` trims a border first."""
    if crop:
        pred_rgb = pred_rgb[..., crop:-crop, crop:-crop, :]
        target_rgb = target_rgb[..., crop:-crop, crop:-crop, :]
    return psnr(rgb_to_ycbcr_y(pred_rgb), rgb_to_ycbcr_y(target_rgb))


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """Normalised Gram matrix of NHWC features, (N, C, C) / (C*H*W), in f32
    (f32 products and sums of x's values)."""
    n, h, w, c = x.shape
    f = x.reshape(n, h * w, c).float()
    return torch.einsum("npc,npd->ncd", f, f) / (c * h * w)
