"""The generator zoo of the port and the `get_net` factory (counterpart of
dip_tpu/models/__init__.py): the skip net, UNet, ResNet, the Texture
Networks pyramid, DCGAN, the identity net of the SR prior experiment, and
the downsamplers."""

from __future__ import annotations

import torch
import torch.nn as nn

from dip_tpu_torch.models.dcgan import DCGAN, dcgan
from dip_tpu_torch.models.downsampler import Downsampler, LearnableDownsampler
from dip_tpu_torch.models.resnet import ResNet
from dip_tpu_torch.models.skip import Skip
from dip_tpu_torch.models.texture_nets import TextureNet, get_texture_nets
from dip_tpu_torch.models.unet import UNet


class Identity(nn.Module):
    """Passes the input through: the degenerate net of sr_prior_effect.ipynb,
    which optimises the pixels themselves (opt_over='net,input')."""

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        del generator  # no parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def get_net(input_depth: int, net_type: str, pad: str, upsample_mode: str,
            n_channels: int = 3, act_fun: str = "LeakyReLU", skip_n33d=128, skip_n33u=128,
            skip_n11=4, num_scales: int = 5, downsample_mode: str = "stride") -> nn.Module:
    """The generator of `net_type` ('skip', 'UNet', 'ResNet', 'texture_nets'
    or 'identity') for `input_depth` input channels, configured as the JAX
    package's get_net configures it."""
    if net_type == "skip":
        def to_list(v):
            return [v] * num_scales if isinstance(v, int) else list(v)

        return Skip(num_input_channels=input_depth, num_output_channels=n_channels,
                    num_channels_down=to_list(skip_n33d), num_channels_up=to_list(skip_n33u),
                    num_channels_skip=to_list(skip_n11), upsample_mode=upsample_mode,
                    downsample_mode=downsample_mode, need_sigmoid=True, need_bias=True,
                    pad=pad, act_fun=act_fun)
    if net_type == "UNet":
        return UNet(num_input_channels=input_depth, num_output_channels=n_channels,
                    feature_scale=4, more_layers=0, concat_x=False,
                    upsample_mode=upsample_mode, pad=pad, norm_kind="batch",
                    need_sigmoid=True, need_bias=True)
    if net_type == "ResNet":
        # the intended wiring, 10 blocks of 16 channels (the reference's
        # get_net passes a norm class as the activation)
        return ResNet(num_input_channels=input_depth, num_output_channels=n_channels,
                      num_blocks=10, num_channels=16, need_residual=True, act_fun=act_fun,
                      need_sigmoid=True, norm_kind="batch", pad=pad)
    if net_type == "texture_nets":
        return TextureNet(num_input_channels=input_depth, ratios=(32, 16, 8, 4, 2, 1),
                          fill_noise=False, pad=pad, num_output_channels=n_channels)
    if net_type == "identity":
        return Identity()
    raise ValueError(f"unknown net type {net_type!r}")


__all__ = ["get_net", "Skip", "UNet", "ResNet", "TextureNet", "get_texture_nets", "DCGAN",
           "dcgan", "Identity", "Downsampler", "LearnableDownsampler"]
