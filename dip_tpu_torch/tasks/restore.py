"""Sparse restoration: recover an image from a random fraction of its
pixels (counterpart of dip_tpu/tasks/restore.py, the restoration.ipynb
recipes). The masked-MSE fit of inpainting with a Bernoulli keep-mask.

Presets: 'barbara' (50 % of the pixels, 11000 iterations, lr 1e-3) and
'kate' (2 %, 1000 iterations, lr 1e-2, avg-pool downsampling).
Backtracking tracks the PSNR on the observed pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from dip_tpu_torch.fit.engine import FitConfig
from dip_tpu_torch.models import Skip
from dip_tpu_torch.ops.losses import masked_mse, psnr
from dip_tpu_torch.tasks.base import TaskSpec
from dip_tpu_torch.utils.masks import get_bernoulli_mask  # re-export

__all__ = ["task", "get_bernoulli_mask"]


def task(img_nhwc, mask_nhwc, preset: str = "barbara", num_iter: int | None = None,
         gt=None) -> TaskSpec:
    img = torch.as_tensor(np.asarray(img_nhwc, dtype=np.float32))
    mask = torch.as_tensor(np.asarray(mask_nhwc, dtype=np.float32))
    n_out, (h, w) = img.shape[-1], img.shape[1:3]
    if preset == "barbara":
        lr, iters, jitter = 1e-3, 11000, 0.03
        model = Skip(num_input_channels=32, num_output_channels=n_out,
                     num_channels_down=[128] * 5, num_channels_up=[128] * 5,
                     num_channels_skip=[4] * 5, upsample_mode="bilinear", pad="reflection")
    elif preset == "kate":
        lr, iters, jitter = 1e-2, 1000, 0.0
        chans = [16, 32, 64, 128, 128]
        model = Skip(num_input_channels=32, num_output_channels=n_out,
                     num_channels_down=chans, num_channels_up=chans,
                     num_channels_skip=[0] * 5, upsample_mode="bilinear",
                     downsample_mode="avg", pad="reflection")
    else:
        raise ValueError(f"unknown preset {preset!r}")

    def metrics_fn(out, ema, aux):
        m = {"psnr_track": psnr(out * aux["mask"], aux["img"] * aux["mask"])}
        if "gt" in aux:
            m["psnr_full"] = psnr(out, aux["gt"])  # against the clean image
        return m

    aux = {"img": img, "mask": mask}
    if gt is not None:
        aux["gt"] = torch.as_tensor(np.asarray(gt, dtype=np.float32))
    return TaskSpec(
        name=f"restore/{preset}",
        model=model,
        cfg=FitConfig(num_iter=iters if num_iter is None else num_iter, lr=lr,
                      reg_noise_std=jitter, backtrack=True),
        loss_fn=lambda p, out, aux: masked_mse(out, aux["img"], aux["mask"]),
        aux=aux,
        metrics_fn=metrics_fn,
        input_depth=32,
        spatial_size=(h, w),
    )
