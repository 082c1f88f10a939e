"""DCGAN-style generator, NHWC in and out (counterpart of
dip_tpu/models/dcgan.py).

A 3x3 stride-1 transposed-conv stem, (num_ups - 3) 2x stages (a 4x4
stride-2 transposed conv, or an upsample then a 3x3 conv), each with BN
and LeakyReLU, and a last 2x stage to the output channels; an optional
sigmoid. No layer has a bias. LeakyReLU's slope is 0.01, the intended
one: the reference passes True as the slope (1.0, the identity). Every
op takes row blocks (ops/rows.Rows) where it takes a tensor
(SpatialEngine); the stem's 2 extra rows go to the last block.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dip_tpu_torch.models.blocks import (Conv, ConvTranspose, TrainBatchNorm, check_conv_wgrad,
                                         reset_parameters_)
from dip_tpu_torch.ops.resample import upsample
from dip_tpu_torch.ops.rows import leaky_relu, sigmoid


class DCGAN(nn.Module):
    """`conv_wgrad` routes the 3x3 convs' weight gradients (need_convT
    False) through the Hopper kernel, as Skip's does."""

    def __init__(self, num_input_channels: int = 2, ndf: int = 32, num_ups: int = 4,
                 need_sigmoid: bool = True, upsample_mode: str = "nearest",
                 need_convT: bool = True, num_output_channels: int = 3,
                 conv_wgrad: str = "off"):
        super().__init__()
        self.num_output_channels = num_output_channels
        self.need_sigmoid = need_sigmoid
        self.upsample_mode = upsample_mode
        self.need_convT = need_convT
        self.conv_wgrad = check_conv_wgrad(conv_wgrad)
        self.stem = ConvTranspose(num_input_channels, ndf, 3, 1, padding=0, bias=False)
        self.bns = nn.ModuleList([TrainBatchNorm(ndf) for _ in range(num_ups - 2)])
        outs = [ndf] * (num_ups - 3) + [num_output_channels]
        self.ups = nn.ModuleList([
            ConvTranspose(ndf, f, 4, 2, padding=1, bias=False) if need_convT
            else Conv(ndf, f, 3, 1, bias=False, pad="zero") for f in outs])

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wgrad = check_conv_wgrad(self.conv_wgrad)
        h = leaky_relu(self.bns[0](self.stem(x)), 0.01)
        last = len(self.ups) - 1
        for i, layer in enumerate(self.ups):
            if self.need_convT:
                h = layer(h)
            else:
                h = upsample(h, 2, "bilinear" if i == last else self.upsample_mode)
                h = layer(h, conv_wgrad=wgrad)
            if i < last:
                h = leaky_relu(self.bns[i + 1](h), 0.01)
        return sigmoid(h) if self.need_sigmoid else h


def dcgan(inp: int = 2, **kwargs) -> DCGAN:
    """The reference's constructor: `inp` input channels."""
    return DCGAN(num_input_channels=inp, **kwargs)
