"""UNet generator, NHWC in and out (counterpart of dip_tpu/models/unet.py).

Four max-pool scales of double convs, widths (64, 128, 256, 512, 1024) //
`feature_scale`, and four up stages (a transposed conv, or an upsample
then a 3x3 conv) that concat the skip tensor and run a norm-free double
conv; `concat_x` concats the avg-pooled input at every depth, and
`more_layers` adds deeper scales of the widest width (the reference
crashes there; the JAX package and this port implement the intent).

Every op takes row blocks (ops/rows.Rows) where it takes a tensor, so
parallel/spatial.py's SpatialEngine runs this forward over them.

The submodules are registered in the order the flax module creates its
own, so interop.flax_paths maps one onto the other by class and index.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dip_tpu_torch.models.blocks import (Conv, ConvTranspose, check_conv_wgrad,
                                         concat_cropped, norm, reset_parameters_)
from dip_tpu_torch.ops.resample import avg_pool, max_pool, upsample
from dip_tpu_torch.ops.rows import cat_channels, relu, sigmoid


class _DoubleConv(nn.Module):
    """(3x3 conv, norm, ReLU) twice (the reference's unetConv2)."""

    def __init__(self, in_channels: int, features: int, norm_kind: str | None, bias: bool,
                 pad: str):
        super().__init__()
        self.convs = nn.ModuleList([Conv(in_channels, features, 3, 1, bias, pad),
                                    Conv(features, features, 3, 1, bias, pad)])
        self.norms = nn.ModuleList([norm(norm_kind, features) for _ in range(2)])

    def forward(self, x: torch.Tensor, conv_wgrad: str) -> torch.Tensor:
        for conv, nrm in zip(self.convs, self.norms):
            x = relu(nrm(conv(x, conv_wgrad=conv_wgrad)))
        return x


def _up_layer(in_channels: int, features: int, mode: str, bias: bool, pad: str) -> nn.Module:
    """The 2x up stage's layer: a 4x4 stride-2 transposed conv ('deconv'),
    or the 3x3 conv that follows a 'bilinear' or 'nearest' upsample."""
    if mode == "deconv":
        return ConvTranspose(in_channels, features, 4, 2, padding=1)
    if mode in ("bilinear", "nearest"):
        return Conv(in_channels, features, 3, 1, bias, pad)
    raise ValueError(f"unknown upsample_mode {mode!r}")


def _up(layer: nn.Module, x: torch.Tensor, mode: str, conv_wgrad: str) -> torch.Tensor:
    if isinstance(layer, ConvTranspose):
        return layer(x)
    return layer(upsample(x, 2, mode), conv_wgrad=conv_wgrad)


class _Up(nn.Module):
    """Upsample, concat the skip tensor, norm-free double conv (unetUp)."""

    def __init__(self, in_channels: int, features: int, mode: str, bias: bool, pad: str):
        super().__init__()
        self.mode = mode
        self.up = _up_layer(in_channels, features, mode, bias, pad)
        self.conv = _DoubleConv(2 * features, features, None, bias, pad)

    def forward(self, x: torch.Tensor, skip_t: torch.Tensor, conv_wgrad: str) -> torch.Tensor:
        up = _up(self.up, x, self.mode, conv_wgrad)
        return self.conv(concat_cropped([up, skip_t]), conv_wgrad)


class UNet(nn.Module):
    """`conv_wgrad` routes the stride-1 3x3 and the 1x1 convs' weight
    gradients through the Hopper kernels, as Skip's does."""

    def __init__(self, num_input_channels: int = 3, num_output_channels: int = 3,
                 feature_scale: int = 4, more_layers: int = 0, concat_x: bool = False,
                 upsample_mode: str = "deconv", pad: str = "zero",
                 norm_kind: str | None = "instance", need_sigmoid: bool = True,
                 need_bias: bool = True, conv_wgrad: str = "off"):
        super().__init__()
        self.num_output_channels = num_output_channels
        self.more_layers = more_layers
        self.concat_x = concat_x
        self.upsample_mode = upsample_mode
        self.need_sigmoid = need_sigmoid
        self.conv_wgrad = check_conv_wgrad(conv_wgrad)
        filters = [f // feature_scale for f in (64, 128, 256, 512, 1024)]
        extra = num_input_channels if concat_x else 0

        def double(cin, f, kind=norm_kind):
            return _DoubleConv(cin, f, kind, need_bias, pad)

        self.down = nn.ModuleList()
        cin = num_input_channels
        for f in filters:
            self.down.append(double(cin, f - extra))
            cin = f
        self.more_down = nn.ModuleList([double(cin, filters[4] - extra)
                                        for _ in range(more_layers)])
        self.more_up = nn.ModuleList([_up_layer(filters[4], filters[4], upsample_mode,
                                                need_bias, pad) for _ in range(more_layers)])
        self.more_conv = nn.ModuleList([double(2 * filters[4], filters[4], None)
                                        for _ in range(more_layers)])
        self.ups = nn.ModuleList([_Up(filters[i + 1], filters[i], upsample_mode, need_bias, pad)
                                  for i in reversed(range(4))])
        self.head = Conv(filters[0], num_output_channels, 1, 1, need_bias, pad)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wgrad = check_conv_wgrad(self.conv_wgrad)
        pooled = [x]
        if self.concat_x:
            for _ in range(4 + self.more_layers):
                pooled.append(avg_pool(pooled[-1], 2))

        def down(i, block, h):
            h = block(h, wgrad)
            return cat_channels([h, pooled[i]]) if self.concat_x else h

        feats = [down(0, self.down[0], x)]
        for i in range(1, 5):
            feats.append(down(i, self.down[i], max_pool(feats[-1], 2)))
        prevs = [feats[-1]]
        for k, block in enumerate(self.more_down):
            prevs.append(down(5 + k, block, max_pool(prevs[-1], 2)))
        u = prevs[-1]
        for j, k in enumerate(reversed(range(self.more_layers))):
            up = _up(self.more_up[j], u, self.upsample_mode, wgrad)
            u = self.more_conv[j](concat_cropped([up, prevs[k]]), wgrad)
        for j, i in enumerate(reversed(range(4))):
            u = self.ups[j](u, feats[i], wgrad)
        out = self.head(u, conv_wgrad=wgrad)
        return sigmoid(out) if self.need_sigmoid else out
