"""Inpainting (inpainting.ipynb): fit the image where the mask is 1, under
MSE over the masked pixels normalised by every pixel (the notebook's
mse(out * mask, img * mask))."""

from __future__ import annotations

import numpy as np
import torch

from dipbench.inputs import fit_seed, smooth_image


def text_mask(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w) float32 of 1 with text-like holes: rows of small zeroed
    blocks, 12 pixels tall and 3 to 10 wide, as a line of glyphs would be."""
    rng = np.random.default_rng(seed)
    mask = np.ones((h, w), np.float32)
    for y0 in range(h // 8, h - h // 8, h // 8):
        for x0 in range(w // 16, w - w // 16, 14):
            if rng.random() < 0.7:
                mask[y0:y0 + 12, x0:x0 + 3 + int(rng.integers(0, 8))] = 0
    return mask


def images(img: dict, fits: int, seed: int, gen: torch.Generator, device) -> dict:
    """The image where the mask is 1, and the mask, each (fits, 1, H, W, C);
    fit i's mask from its own seed, drawn on the host."""
    h, w, c = img["height"], img["width"], img["channels"]
    picture = smooth_image(img, fits, gen, device)
    masks = np.stack([text_mask(h, w, fit_seed(seed, i)) for i in range(fits)])
    mask = torch.from_numpy(masks).to(device).view(fits, 1, h, w, 1).expand(-1, -1, -1, -1, c)
    mask = mask.contiguous()
    return {"img": picture * mask, "mask": mask}


def reference_loss(out: torch.Tensor, aux: dict) -> torch.Tensor:
    d = (out - aux["img"]) * aux["mask"]
    return torch.mean(d * d)


def program_fns():
    """The port's loss and metrics (PSNR over the masked pixels)."""
    from dip_tpu_torch.ops.losses import masked_mse, psnr

    def loss(p, out, aux):
        return masked_mse(out, aux["img"], aux["mask"])

    def metrics(out, ema, aux):
        return {"psnr_track": psnr(out * aux["mask"], aux["img"] * aux["mask"])}

    return loss, metrics
