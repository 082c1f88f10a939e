"""ResNet generator, NHWC in and out (counterpart of dip_tpu/models/resnet.py).

A stem conv and activation; `num_blocks` residual blocks of [3x3 conv
without bias, norm, act, 3x3 conv without bias, norm] plus the block's
input; a 3x3 conv and norm neck; a 3x3 conv head and a sigmoid. As in the
JAX package this is the configuration the reference intended: its
get_net passes a norm class as the activation and would crash. Every op
takes row blocks (ops/rows.Rows) where it takes a tensor (SpatialEngine).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dip_tpu_torch.models.blocks import Conv, act, check_conv_wgrad, norm, reset_parameters_
from dip_tpu_torch.ops.rows import sigmoid


class _ResBlock(nn.Module):
    def __init__(self, features: int, norm_kind: str, act_fun: str, residual: bool):
        super().__init__()
        self.act_fun = act_fun
        self.residual = residual
        self.convs = nn.ModuleList([Conv(features, features, 3, 1, bias=False, pad="zero")
                                    for _ in range(2)])
        self.norms = nn.ModuleList([norm(norm_kind, features) for _ in range(2)])

    def forward(self, x: torch.Tensor, conv_wgrad: str) -> torch.Tensor:
        h = act(self.norms[0](self.convs[0](x, conv_wgrad=conv_wgrad)), self.act_fun)
        h = self.norms[1](self.convs[1](h, conv_wgrad=conv_wgrad))
        return h + x if self.residual else h


class ResNet(nn.Module):
    """`conv_wgrad` routes the 3x3 convs' weight gradients through the
    Hopper kernel, as Skip's does (the padded stem and head at halo 0)."""

    def __init__(self, num_input_channels: int = 3, num_output_channels: int = 3,
                 num_blocks: int = 10, num_channels: int = 16, need_residual: bool = True,
                 act_fun: str = "LeakyReLU", need_sigmoid: bool = True,
                 norm_kind: str = "batch", pad: str = "reflection", conv_wgrad: str = "off"):
        super().__init__()
        self.num_output_channels = num_output_channels
        self.act_fun = act_fun
        self.need_sigmoid = need_sigmoid
        self.conv_wgrad = check_conv_wgrad(conv_wgrad)
        c = num_channels
        self.stem = Conv(num_input_channels, c, 3, 1, True, pad)
        self.blocks = nn.ModuleList([_ResBlock(c, norm_kind, act_fun, need_residual)
                                     for _ in range(num_blocks)])
        self.neck = Conv(c, c, 3, 1, True, "zero")
        self.neck_norm = norm(norm_kind, c)
        self.head = Conv(c, num_output_channels, 3, 1, True, pad)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wgrad = check_conv_wgrad(self.conv_wgrad)
        h = act(self.stem(x, conv_wgrad=wgrad), self.act_fun)
        for block in self.blocks:
            h = block(h, wgrad)
        h = self.neck_norm(self.neck(h, conv_wgrad=wgrad))
        h = self.head(h, conv_wgrad=wgrad)
        return sigmoid(h) if self.need_sigmoid else h
