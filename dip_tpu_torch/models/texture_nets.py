"""Multi-scale pyramid generator in the style of Texture Networks, NHWC in
and out (counterpart of dip_tpu/models/texture_nets.py).

One branch per pyramid ratio: the avg-pooled input (or, with
`fill_noise`, fresh noise of its shape) through three conv-BN-act stages.
Branches merge coarse to fine: each merge batch-norms both sides, concats
them, runs three conv-BN-act stages and upsamples, until the finest level
emits the output conv. Padding is the intended integer padding (the
reference's float padding crashes under Python 3). Every op takes row
blocks (ops/rows.Rows) where it takes a tensor (SpatialEngine); the noise
is drawn for the whole image and cut into the blocks' rows.

Convs and BNs are created in the flax module's order, so `convs.{i}` is
flax's `Conv_{i}` and `bns.{i}` its `TrainBatchNorm_{i}`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from dip_tpu_torch.models.blocks import (Conv, GenNoise, TrainBatchNorm, act, check_conv_wgrad,
                                         concat_cropped, reset_parameters_)
from dip_tpu_torch.ops.resample import avg_pool, upsample
from dip_tpu_torch.ops.rows import sigmoid


class TextureNet(nn.Module):
    """With `fill_noise` the forward needs a generator on the input's
    device for the branches' noise. `conv_wgrad` routes the 3x3 and 1x1
    convs' weight gradients through the Hopper kernels, as Skip's does."""

    def __init__(self, num_input_channels: int = 3, ratios: Sequence[int] = (32, 16, 8, 4, 2, 1),
                 fill_noise: bool = False, pad: str = "zero", need_sigmoid: bool = False,
                 conv_num: int = 8, upsample_mode: str = "nearest",
                 num_output_channels: int = 3, conv_wgrad: str = "off"):
        super().__init__()
        self.ratios = tuple(ratios)
        self.fill_noise = fill_noise
        self.need_sigmoid = need_sigmoid
        self.upsample_mode = upsample_mode
        self.num_output_channels = num_output_channels
        self.conv_wgrad = check_conv_wgrad(conv_wgrad)
        self.noise = GenNoise(num_input_channels)
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()

        def cba(cin, features, ksize):
            self.convs.append(Conv(cin, features, ksize, 1, True, pad))
            self.bns.append(TrainBatchNorm(features))

        for i in range(len(self.ratios)):
            cba(num_input_channels, conv_num, 3)
            cba(conv_num, conv_num, 3)
            cba(conv_num, conv_num, 1)
            if i == 0:
                continue
            width = conv_num * (i + 1)
            self.bns.append(TrainBatchNorm(conv_num))      # the branch
            self.bns.append(TrainBatchNorm(conv_num * i))  # the coarser levels
            cba(width, width, 3)
            cba(width, width, 3)
            cba(width, width, 1)
        self.convs.append(Conv(conv_num * len(self.ratios), num_output_channels, 1, 1, True,
                               pad))

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters_(self, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if self.fill_noise and generator is None:
            raise ValueError("fill_noise needs a generator on the input's device")
        wgrad = check_conv_wgrad(self.conv_wgrad)
        convs, bns = iter(self.convs), iter(self.bns)

        def cba(h):
            return act(next(bns)(next(convs)(h, conv_wgrad=wgrad)), "LeakyReLU")

        cur = None
        for i, ratio in enumerate(self.ratios):
            b = avg_pool(x, ratio) if ratio > 1 else x
            if self.fill_noise:
                b = self.noise(b, generator)
            b = cba(cba(cba(b)))
            if i == 0:
                cur = upsample(b, 2, self.upsample_mode)
                continue
            b = next(bns)(b)
            m = concat_cropped([next(bns)(cur), b])
            m = cba(cba(cba(m)))
            if i == len(self.ratios) - 1:
                cur = next(convs)(m, conv_wgrad=wgrad)
            else:
                cur = upsample(m, 2, self.upsample_mode)
        return sigmoid(cur) if self.need_sigmoid else cur


def get_texture_nets(inp: int = 3, **kwargs) -> TextureNet:
    """The reference's constructor: `inp` input channels."""
    return TextureNet(num_input_channels=inp, **kwargs)
