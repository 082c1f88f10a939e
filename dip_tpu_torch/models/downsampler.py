"""Downsampler modules (counterpart of dip_tpu/models/downsampler.py), NHWC.

`Downsampler` wraps ops/resample.py's `downsample` (a fixed kernel; the
Hopper kernel on a CUDA tensor). `LearnableDownsampler` holds the K x K
kernel as a trainable f32 parameter, initialised to the same profile, for
the SR task's opt_over='net,down' mode where the degradation operator is
optimised too.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dip_tpu_torch.ops.pad import pad2d
from dip_tpu_torch.ops.resample import downsample, pad_width, resample_kernel_2d


class Downsampler(nn.Module):
    """Fixed anti-aliased downsampler."""

    def __init__(self, factor: int, kernel_type: str = "lanczos2", phase: float = 0.5,
                 preserve_size: bool = True):
        super().__init__()
        self.factor = factor
        self.kernel_type = kernel_type
        self.phase = phase
        self.preserve_size = preserve_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return downsample(x, self.factor, self.kernel_type, self.phase, self.preserve_size)


class LearnableDownsampler(nn.Module):
    """Downsampler whose 2-D kernel is a parameter shared by every channel,
    initialised to the reference profile. The forward is a stride-`factor`
    correlation of the replication-padded input: one depthwise conv."""

    def __init__(self, factor: int, kernel_type: str = "lanczos2", phase: float = 0.5,
                 preserve_size: bool = True):
        super().__init__()
        self.factor = factor
        self.kernel_type = kernel_type
        self.phase = phase
        self.preserve_size = preserve_size
        self.kernel = nn.Parameter(self._initial_kernel())

    def _initial_kernel(self) -> torch.Tensor:
        k2 = resample_kernel_2d(self.factor, self.kernel_type, self.phase)
        return torch.as_tensor(k2, dtype=torch.float32)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.kernel.copy_(self._initial_kernel())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ksize = self.kernel.shape[0]
        x = pad2d(x, pad_width(ksize, self.factor, self.preserve_size), "replication")
        c = x.shape[-1]
        w = self.kernel.to(x.dtype).expand(c, 1, ksize, ksize)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.factor, groups=c)
        return y.permute(0, 2, 3, 1)
