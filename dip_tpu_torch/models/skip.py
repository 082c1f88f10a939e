"""The skip net, DIP's encoder-decoder with per-scale skips, NHWC in and out.

Counterpart of dip_tpu/models/skip.py:

  down pass, scale i:  skip_i = act(bn(conv1x1(x_i)))
                       x_{i+1} = act(bn(conv(act(bn(conv_s2(x_i))))))
  up pass, scale i:    u = bn(concat(skip_i, upsample_2x(u)))
                       u = act(bn(conv_k(u)))
                       u = act(bn(conv1x1(u))) if need1x1_up
  head:                sigmoid(conv1x1(u))

The convs and BNs are created in the order the flax module creates them,
so `convs.{i}` is flax's `Conv_{i}` and `bns.{i}` its `TrainBatchNorm_{i}`
(dip_tpu_torch/interop.py maps one onto the other).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from dip_tpu_torch.models.blocks import (Conv, TrainBatchNorm, act, check_conv_wgrad,
                                         concat_cropped, crop_to_min)
from dip_tpu_torch.ops.resample import upsample
from dip_tpu_torch.ops.up_conv import Up2, can_fuse_up2


def _per_scale(value, n):
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"expected {n} per-scale values, got {value!r}")
        return list(value)
    return [value] * n


class Skip(nn.Module):
    """Encoder-decoder with skip connections (the DIP generator).

    fuse_concat keeps (skip, up) as separate parts through the post-concat
    BN and conv; fold_bn folds that BN into the conv; up_conv runs each
    eligible decoder upsample -> 3x3 conv as the fused seam
    (ops/up_conv.py); seam_carry adds the decoder's skip-branch conv result
    in the seam kernel's epilogue (the JAX package's dispatch.seam_carry,
    off by default there too); conv_wgrad ('off' | '1x1' | '3x3' | 'all')
    takes the weight gradients of the stride-1 3x3 and the 1x1 convs from
    the Hopper kernels (the JAX package's DIP_PALLAS_WGRAD, off by default
    there too). None of them changes a parameter or a result beyond
    rounding; the seam rounds its operands to bf16.
    """

    def __init__(
        self,
        num_input_channels: int = 2,
        num_output_channels: int = 3,
        num_channels_down: Sequence[int] = (16, 32, 64, 128, 128),
        num_channels_up: Sequence[int] = (16, 32, 64, 128, 128),
        num_channels_skip: Sequence[int] = (4, 4, 4, 4, 4),
        filter_size_down: int | Sequence[int] = 3,
        filter_size_up: int | Sequence[int] = 3,
        filter_skip_size: int = 1,
        need_sigmoid: bool = True,
        need_bias: bool = True,
        pad: str = "zero",
        upsample_mode: str | Sequence[str] = "nearest",
        downsample_mode: str | Sequence[str] = "stride",
        act_fun: str = "LeakyReLU",
        need1x1_up: bool = True,
        fuse_concat: bool = True,
        fold_bn: bool = True,
        up_conv: bool = True,
        seam_carry: bool = False,
        conv_wgrad: str = "off",
    ):
        super().__init__()
        n = len(num_channels_down)
        if not len(num_channels_up) == len(num_channels_skip) == n:
            raise ValueError("channel lists must have one entry per scale")
        self.num_output_channels = num_output_channels
        self.ch_skip = list(num_channels_skip)
        self.up_modes = _per_scale(upsample_mode, n)
        self.k_up = _per_scale(filter_size_up, n)
        self.need_sigmoid = need_sigmoid
        self.pad = pad
        self.act_fun = act_fun
        self.need1x1_up = need1x1_up
        self.fuse_concat = fuse_concat
        self.fold_bn = fold_bn
        self.up_conv = up_conv
        self.seam_carry = seam_carry
        self.conv_wgrad = check_conv_wgrad(conv_wgrad)
        self.down_modes = _per_scale(downsample_mode, n)
        self.k_down = _per_scale(filter_size_down, n)
        self.filter_skip_size = filter_skip_size
        down_modes, k_down = self.down_modes, self.k_down

        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()

        def cba(cin, features, ksize, stride=1, dmode="stride"):
            self.convs.append(Conv(cin, features, ksize, stride, need_bias, pad, dmode))
            self.bns.append(TrainBatchNorm(features))

        cin = num_input_channels
        for i in range(n):
            if num_channels_skip[i]:
                cba(cin, num_channels_skip[i], filter_skip_size)
            cba(cin, num_channels_down[i], k_down[i], 2, down_modes[i])
            cba(num_channels_down[i], num_channels_down[i], k_down[i])
            cin = num_channels_down[i]
        for i in reversed(range(n)):
            cat = num_channels_skip[i] + cin
            self.bns.append(TrainBatchNorm(cat))
            cba(cat, num_channels_up[i], self.k_up[i])
            if need1x1_up:
                cba(num_channels_up[i], num_channels_up[i], 1)
            cin = num_channels_up[i]
        self.convs.append(Conv(cin, num_output_channels, 1, 1, need_bias, pad))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Torch-style init from `generator` (a CPU generator: the same
        weights on every device)."""
        for conv in self.convs:
            conv.reset_parameters(generator)
        for bn in self.bns:
            bn.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs, bns = iter(self.convs), iter(self.bns)
        wgrad = check_conv_wgrad(self.conv_wgrad)

        def cba(h):
            h = next(convs)(h, seam_carry=self.seam_carry, conv_wgrad=wgrad)
            return act(next(bns)(h), self.act_fun)

        n = len(self.ch_skip)
        skips: list[torch.Tensor | None] = []
        for i in range(n):
            skips.append(cba(x) if self.ch_skip[i] else None)
            x = cba(cba(x))

        u = x
        for i in reversed(range(n)):
            sk = skips[i]
            fuse_up = (
                self.up_conv
                and can_fuse_up2(self.up_modes[i], self.k_up[i], 1, self.pad,
                                 u.shape[1], u.shape[2])
                and (sk is None or (self.fuse_concat and tuple(sk.shape[1:3])
                                    == (2 * u.shape[1], 2 * u.shape[2]))))
            if fuse_up:
                uu = Up2(u, self.up_modes[i])
                u = [sk, uu] if sk is not None else uu
            else:
                u = upsample(u, 2, self.up_modes[i])
                if sk is not None:
                    u = crop_to_min([sk, u]) if self.fuse_concat else concat_cropped([sk, u])
            foldable = self.pad in ("reflection", "replication") or self.k_up[i] == 1
            if self.fold_bn and foldable:
                u, s, t = next(bns)(u, as_affine=True)
                u = act(next(bns)(next(convs)(u, s, t, self.seam_carry, wgrad)), self.act_fun)
            else:
                u = cba(next(bns)(u))
            if self.need1x1_up:
                u = cba(u)

        u = next(convs)(u, conv_wgrad=wgrad)
        return torch.sigmoid(u) if self.need_sigmoid else u


def skip(num_input_channels: int = 2, num_output_channels: int = 3, **kwargs) -> Skip:
    """Constructor with the reference's signature (skip.py:5-11). Unlike
    the JAX package's, which takes the input width from z at init, it
    passes `num_input_channels` on: a torch conv needs it at construction."""
    return Skip(num_input_channels=num_input_channels,
                num_output_channels=num_output_channels, **kwargs)
