"""Inpainting: a masked-MSE fit (counterpart of dip_tpu/tasks/inpaint.py,
the inpainting.ipynb recipes).

Presets: 'vase' (meshgrid input, a skip net without skips), 'kate' (text
inpainting, the README's convergence smoke test: 5 scales of 128 channels
with 128-channel skips) and 'library' (a 6-scale net with 5x5 down-convs
and weight jitter; `net_type` 'UNet' or 'ResNet' fit those nets at lr
1e-3 without weight jitter).
"""

from __future__ import annotations

import numpy as np
import torch

from dip_tpu_torch.fit.engine import FitConfig
from dip_tpu_torch.models import ResNet, Skip, UNet
from dip_tpu_torch.ops.losses import masked_mse, psnr
from dip_tpu_torch.tasks.base import TaskSpec


def _metrics(has_gt: bool):
    def fn(out, ema, aux):
        m = {"psnr_track": psnr(out * aux["mask"], aux["img"] * aux["mask"])}
        if has_gt:
            m["psnr_gt"] = psnr(out, aux["gt"])
        return m
    return fn


def task(img_nhwc, mask_nhwc, preset: str = "kate", gt=None, num_iter: int | None = None,
         net_type: str = "skip") -> TaskSpec:
    """The inpainting TaskSpec: fit the net to the image where the mask is
    1, under masked_mse."""
    img = torch.as_tensor(np.asarray(img_nhwc, dtype=np.float32))
    mask = torch.as_tensor(np.asarray(mask_nhwc, dtype=np.float32))
    n_out, (h, w) = img.shape[-1], img.shape[1:3]
    input_method, input_depth = "noise", 32
    param_noise = False
    lr, jitter = 0.01, 0.03
    common = dict(num_output_channels=n_out, upsample_mode="nearest", pad="reflection")

    if preset == "vase":
        input_method, input_depth = "meshgrid", 2
        iters = 5001
        model = Skip(num_input_channels=2, num_channels_down=[128] * 5,
                     num_channels_up=[128] * 5, num_channels_skip=[0] * 5, **common)
    elif preset == "kate":
        iters = 6001
        model = Skip(num_input_channels=32, num_channels_down=[128] * 5,
                     num_channels_up=[128] * 5, num_channels_skip=[128] * 5, **common)
    elif preset == "library":
        input_depth, iters, jitter = 1, 3001, 0.0
        if net_type.startswith("skip"):
            depth = int(net_type[-1]) if net_type[-1].isdigit() else 6
            param_noise = True
            chans = [16, 32, 64, 128, 128, 128][:depth]
            model = Skip(num_input_channels=1, num_channels_down=chans, num_channels_up=chans,
                         num_channels_skip=[0] * depth, filter_size_down=5, filter_size_up=3,
                         need1x1_up=False, **common)
        elif net_type == "UNet":
            lr = 1e-3
            model = UNet(num_input_channels=1, num_output_channels=n_out, feature_scale=8,
                         more_layers=1, upsample_mode="deconv", pad="zero",
                         norm_kind="instance")
        elif net_type == "ResNet":
            lr = 1e-3
            model = ResNet(num_input_channels=1, num_output_channels=n_out, num_blocks=8,
                           num_channels=32)
        else:
            raise ValueError(f"unknown net_type {net_type!r}")
    else:
        raise ValueError(f"unknown preset {preset!r}")

    aux = {"img": img, "mask": mask}
    if gt is not None:
        aux["gt"] = torch.as_tensor(np.asarray(gt, dtype=np.float32))
    return TaskSpec(
        name=f"inpaint/{preset}",
        model=model,
        cfg=FitConfig(num_iter=iters if num_iter is None else num_iter, lr=lr,
                      reg_noise_std=jitter, param_noise=param_noise),
        loss_fn=lambda p, out, aux: masked_mse(out, aux["img"], aux["mask"]),
        aux=aux,
        metrics_fn=_metrics(gt is not None),
        input_depth=input_depth,
        input_method=input_method,
        spatial_size=(h, w),
    )
