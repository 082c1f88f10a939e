"""Blind denoising / JPEG-artifact removal (counterpart of
dip_tpu/tasks/denoise.py): fit f_theta(z) to the noisy image under plain
MSE. Presets: 'f16' (the sigma=25 recipe) and 'snail' (blind de-JPEG).
"""

from __future__ import annotations

import numpy as np
import torch

from dip_tpu_torch.fit.engine import FitConfig
from dip_tpu_torch.models import Skip
from dip_tpu_torch.ops.losses import mse, psnr
from dip_tpu_torch.tasks.base import TaskSpec


def get_noisy_image(img_hwc: np.ndarray, sigma: float,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Add N(0, sigma) and clip to [0,1]; `sigma` in [0,1] units."""
    rng = rng or np.random.default_rng(0)
    noisy = img_hwc + rng.normal(scale=sigma, size=img_hwc.shape)
    return np.clip(noisy, 0, 1).astype(np.float32)


def _metrics(has_gt: bool):
    def fn(out, ema, aux):
        m = {"psnr_track": psnr(out, aux["noisy"])}
        if has_gt:
            m["psnr_gt"] = psnr(out, aux["gt"])
            m["psnr_gt_sm"] = psnr(ema, aux["gt"])
        return m
    return fn


def task(
    img_noisy_nhwc,
    preset: str = "f16",
    gt=None,
    num_iter: int | None = None,
    lr: float = 0.01,
    reg_noise_std: float | None = None,
    exp_weight: float = 0.99,
    input_depth: int | None = None,
) -> TaskSpec:
    """The denoising TaskSpec.

    'f16': 3000 iters, input_depth 32, skip 128x5 with 4-channel skips,
    jitter 1/30, bilinear up, reflection pad, EMA 0.99, backtracking.
    'snail': 2400 iters, input_depth 3, channels [8,16,32,64,128], skips
    [0,0,0,4,4].
    """
    img_noisy = torch.as_tensor(np.asarray(img_noisy_nhwc, dtype=np.float32))
    n_out, (h, w) = img_noisy.shape[-1], img_noisy.shape[1:3]
    if preset == "f16":
        depth = 32 if input_depth is None else input_depth
        chans, skips, iters = [128] * 5, [4] * 5, 3000
    elif preset == "snail":
        depth = 3 if input_depth is None else input_depth
        chans, skips, iters = [8, 16, 32, 64, 128], [0, 0, 0, 4, 4], 2400
    else:
        raise ValueError(f"unknown preset {preset!r}")
    model = Skip(num_input_channels=depth, num_output_channels=n_out,
                 num_channels_down=chans, num_channels_up=chans,
                 num_channels_skip=skips, upsample_mode="bilinear",
                 pad="reflection")
    cfg = FitConfig(
        num_iter=iters if num_iter is None else num_iter,
        lr=lr,
        reg_noise_std=1.0 / 30 if reg_noise_std is None else reg_noise_std,
        exp_weight=exp_weight,
        backtrack=True,
    )
    aux = {"noisy": img_noisy}
    if gt is not None:
        aux["gt"] = torch.as_tensor(np.asarray(gt, dtype=np.float32))
    return TaskSpec(
        name=f"denoise/{preset}",
        model=model,
        cfg=cfg,
        loss_fn=lambda p, out, aux: mse(out, aux["noisy"]),
        aux=aux,
        metrics_fn=_metrics(gt is not None),
        input_depth=depth,
        spatial_size=(h, w),
    )
