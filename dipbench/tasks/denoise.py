"""Denoising (denoising.ipynb): fit the noisy image under MSE."""

from __future__ import annotations

import torch

from dipbench.inputs import smooth_image


def images(img: dict, fits: int, seed: int, gen: torch.Generator, device) -> torch.Tensor:
    """The target: a smooth image under N(0, sigma) noise, clipped to [0, 1],
    (fits, 1, H, W, C)."""
    del seed
    clean = smooth_image(img, fits, gen, device)
    noise = torch.randn(clean.shape, generator=gen, device=device)
    return (clean + img["sigma"] * noise).clamp(0, 1)


def reference_loss(out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = out - target
    return torch.mean(d * d)


def program_fns():
    """The port's loss and metrics (a metric row a step: PSNR to the target)."""
    from dip_tpu_torch.ops.losses import mse, psnr

    def loss(p, out, aux):
        return mse(out, aux)

    def metrics(out, ema, aux):
        return {"psnr_track": psnr(out, aux)}

    return loss, metrics
