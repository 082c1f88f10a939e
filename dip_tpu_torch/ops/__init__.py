"""Tensor ops of the port; the ops/hopper_*.py modules hold the Hopper
kernels' wrappers and plain versions (sources in csrc/)."""

from dip_tpu_torch.ops.color import rgb_to_ycbcr_y
from dip_tpu_torch.ops.losses import gram_matrix, masked_mse, mse, psnr, psnr_y, tv_loss
from dip_tpu_torch.ops.pad import pad2d
from dip_tpu_torch.ops.resample import (avg_pool, downsample, max_pool, resample_kernel_1d,
                                        resample_kernel_2d, upsample)

__all__ = [
    "pad2d",
    "resample_kernel_1d",
    "resample_kernel_2d",
    "downsample",
    "upsample",
    "avg_pool",
    "max_pool",
    "mse",
    "masked_mse",
    "tv_loss",
    "psnr",
    "psnr_y",
    "gram_matrix",
    "rgb_to_ycbcr_y",
]
