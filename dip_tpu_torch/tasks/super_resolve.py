"""Single-image super-resolution (counterpart of dip_tpu/tasks/super_resolve.py,
the super-resolution.ipynb recipe).

The generator runs at HR; the differentiable anti-aliased downsampler maps
its output to LR, where the MSE to the observation is taken, plus an
optional TV term on the HR output. Presets: x4 (2000 iters, jitter 0.03)
and x8 (4000 iters, jitter 0.05).

The LR observation of `load_lr_hr` comes from PIL's Lanczos resize, a
different operator from the in-loss downsampler, as in the reference. On a
CUDA device the in-loss downsampler is the Hopper kernel; on the CPU its
plain version (the JAX package's 'xla'/'pallas' choice is the device here).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from dip_tpu_torch.fit.engine import FitConfig
from dip_tpu_torch.models import Identity, LearnableDownsampler, Skip
from dip_tpu_torch.ops.losses import mse, psnr, tv_loss
from dip_tpu_torch.ops.resample import downsample
from dip_tpu_torch.tasks.base import TaskSpec
from dip_tpu_torch.utils.image_io import get_image, pil_to_np


def load_lr_hr(path: str, imsize=-1, factor: int = 4, enforce_div32: str | None = "CROP"):
    """Load, centre-crop to a multiple of 32, and make the LR observation by
    PIL Lanczos. Returns a dict of PIL images and HWC arrays."""
    from PIL import Image

    img_orig_pil, img_orig_np = get_image(path, imsize)
    if enforce_div32 == "CROP":
        new_w = img_orig_pil.size[0] - img_orig_pil.size[0] % 32
        new_h = img_orig_pil.size[1] - img_orig_pil.size[1] % 32
        bbox = (
            (img_orig_pil.size[0] - new_w) // 2,
            (img_orig_pil.size[1] - new_h) // 2,
            (img_orig_pil.size[0] + new_w) // 2,
            (img_orig_pil.size[1] + new_h) // 2,
        )
        img_hr_pil = img_orig_pil.crop(bbox)
    else:
        img_hr_pil = img_orig_pil
    lr_size = (img_hr_pil.size[0] // factor, img_hr_pil.size[1] // factor)
    img_lr_pil = img_hr_pil.resize(lr_size, Image.LANCZOS)
    return {
        "orig_pil": img_orig_pil,
        "orig_np": img_orig_np,
        "HR_pil": img_hr_pil,
        "HR_np": pil_to_np(img_hr_pil),
        "LR_pil": img_lr_pil,
        "LR_np": pil_to_np(img_lr_pil),
    }


def get_baselines(img_lr_pil, img_hr_pil):
    """Bicubic, unsharp-masked bicubic and nearest upsampling baselines."""
    from PIL import Image, ImageFilter

    bicubic = img_lr_pil.resize(img_hr_pil.size, Image.BICUBIC)
    nearest = img_lr_pil.resize(img_hr_pil.size, Image.NEAREST)
    sharp = bicubic.filter(ImageFilter.UnsharpMask())
    return pil_to_np(bicubic), pil_to_np(sharp), pil_to_np(nearest)


def put_in_center(img_hwc: np.ndarray, target_hw: tuple[int, int]) -> np.ndarray:
    """Zero-pad embed into a larger canvas."""
    h, w, c = img_hwc.shape
    out = np.zeros((target_hw[0], target_hw[1], c), img_hwc.dtype)
    y0 = (target_hw[0] - h) // 2
    x0 = (target_hw[1] - w) // 2
    out[y0:y0 + h, x0:x0 + w] = img_hwc
    return out


def task(
    img_lr_nhwc,
    factor: int = 4,
    hr_gt=None,
    kernel_type: str = "lanczos2",
    tv_weight: float = 0.0,
    num_iter: int | None = None,
    lr: float = 0.01,
    reg_noise_std: float | None = None,
    learnable_downsampler: bool = False,
    net: str = "skip",
) -> TaskSpec:
    """The SR TaskSpec; HR size = LR size * factor.

    learnable_downsampler: the degradation kernel is a trainable leaf
    'down' (opt_over='net,down'). net='identity' is sr_prior_effect.ipynb's
    degenerate mode: no generator, the HR pixels themselves are optimised
    (opt_over='net,input', no backtracking).
    """
    img_lr = torch.as_tensor(np.asarray(img_lr_nhwc, dtype=np.float32))
    n_out = img_lr.shape[-1]
    hr_h, hr_w = img_lr.shape[1] * factor, img_lr.shape[2] * factor
    iters, jitter = (4000, 0.05) if factor == 8 else (2000, 0.03)
    iters = iters if num_iter is None else num_iter
    jitter = jitter if reg_noise_std is None else reg_noise_std

    opt_input = False
    input_depth = 32
    if net == "skip":
        model = Skip(num_input_channels=input_depth, num_output_channels=n_out,
                     num_channels_down=[128] * 5, num_channels_up=[128] * 5,
                     num_channels_skip=[4] * 5, upsample_mode="bilinear",
                     pad="reflection")
    elif net == "identity":
        model = Identity()
        opt_input = True
        input_depth = n_out
    else:
        raise ValueError(f"unknown net {net!r}")

    def fixed_down(out_hr):
        return downsample(out_hr, factor, kernel_type, 0.5, True)

    extra_params = None
    if learnable_downsampler:
        down_mod = LearnableDownsampler(factor, kernel_type)
        extra_params = {"down": down_mod.kernel.detach().clone()}

        def degrade(p, out_hr):
            return functional_call(down_mod, {"kernel": p["down"]}, (out_hr,))
    else:
        def degrade(p, out_hr):
            return fixed_down(out_hr)

    def loss_fn(p, out_hr, aux):
        total = mse(degrade(p, out_hr), aux["lr"])
        if tv_weight > 0:
            total = total + tv_weight * tv_loss(out_hr)
        return total

    def metrics_fn(out_hr, ema, aux):
        # the fixed downsampler even when the kernel is learned, so that
        # psnr_lr stays comparable
        p_lr = psnr(fixed_down(out_hr), aux["lr"])
        m = {"psnr_track": p_lr, "psnr_lr": p_lr}
        if "hr_gt" in aux:
            m["psnr_hr"] = psnr(out_hr, aux["hr_gt"])
        return m

    aux = {"lr": img_lr}
    if hr_gt is not None:
        aux["hr_gt"] = torch.as_tensor(np.asarray(hr_gt, dtype=np.float32))
    opt_over = "net" + (",input" if opt_input else "") + (
        ",down" if learnable_downsampler else "")
    return TaskSpec(
        name=f"sr/x{factor}" + ("" if net == "skip" else f"/{net}"),
        model=model,
        cfg=FitConfig(num_iter=iters, lr=lr, reg_noise_std=jitter,
                      backtrack=not opt_input, opt_input=opt_input, opt_over=opt_over),
        loss_fn=loss_fn,
        aux=aux,
        metrics_fn=metrics_fn,
        input_depth=input_depth,
        spatial_size=(hr_h, hr_w),
        extra_params=extra_params,
    )
