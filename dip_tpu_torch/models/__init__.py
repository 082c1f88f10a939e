"""Generators of the port: the skip net, the identity net of the SR prior
experiment, and the downsamplers."""

import torch
import torch.nn as nn

from dip_tpu_torch.models.downsampler import Downsampler, LearnableDownsampler
from dip_tpu_torch.models.skip import Skip


class Identity(nn.Module):
    """Passes the input through: the degenerate net of sr_prior_effect.ipynb,
    which optimises the pixels themselves (opt_over='net,input')."""

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        del generator  # no parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


__all__ = ["Skip", "Identity", "Downsampler", "LearnableDownsampler"]
