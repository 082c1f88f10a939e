"""Flash/no-flash reconstruction (counterpart of
dip_tpu/tasks/flash_no_flash.py, the flash-no-flash.ipynb recipe).

The flash image is the network's input (not noise); the loss pulls the
output toward the no-flash image, carrying its lighting over while the
flash image's detail comes through the net. Cells 7-8: 601 iterations,
lr 0.1, a skip net with nearest upsampling at the two top scales and
bilinear below. Both modes take the fused seam (models/skip.py), so every
decoder scale runs the seam's kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from dip_tpu_torch.fit.engine import FitConfig
from dip_tpu_torch.models import Skip
from dip_tpu_torch.ops.losses import mse, psnr
from dip_tpu_torch.tasks.base import TaskSpec

UP_MODES = ["nearest", "nearest", "bilinear", "bilinear", "bilinear"]


def task(img_flash_nhwc, img_noflash_nhwc, num_iter: int = 601, lr: float = 0.1,
         reg_noise_std: float = 0.0) -> TaskSpec:
    """The flash/no-flash TaskSpec: skip 128x5 with 4-channel skips,
    reflection pad, the flash image as z, MSE to the no-flash image, and
    psnr_track against it."""
    flash = torch.as_tensor(np.asarray(img_flash_nhwc, dtype=np.float32))
    noflash = torch.as_tensor(np.asarray(img_noflash_nhwc, dtype=np.float32))
    model = Skip(num_input_channels=flash.shape[-1], num_output_channels=noflash.shape[-1],
                 num_channels_down=[128] * 5, num_channels_up=[128] * 5,
                 num_channels_skip=[4] * 5, upsample_mode=UP_MODES, pad="reflection")
    return TaskSpec(
        name="flash_no_flash",
        model=model,
        cfg=FitConfig(num_iter=num_iter, lr=lr, reg_noise_std=reg_noise_std),
        loss_fn=lambda p, out, aux: mse(out, aux["noflash"]),
        aux={"noflash": noflash},
        metrics_fn=lambda out, ema, aux: {"psnr_track": psnr(out, aux["noflash"])},
        net_input=flash,
    )
