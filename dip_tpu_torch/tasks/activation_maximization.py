"""Activation maximization: synthesize an input that excites a chosen unit
(counterpart of dip_tpu/tasks/activation_maximization.py).

Objectives of the hook-free Matcher: an fc layer maximizes or matches the
class logit; a conv layer the windowed centre crop of one channel
(window_size sets the excited region). Recipe: 3100 steps, lr 1e-3 for
conv layers and 1e-2 for fc8, jitter 0.03, weight jitter on, the loss x5,
optional TV on the preprocessed output (beta 2) and an optional penalty
on the output inside a mask. The generator is the inversion net with
reflection padding, so its two deepest decoder scales (LR 4^2 and 8^2 at
imsize_net 256) take the fused seam.
"""

from __future__ import annotations

import numpy as np
import torch

from dip_tpu_torch.fit.engine import FitConfig
from dip_tpu_torch.ops.losses import tv_loss
from dip_tpu_torch.pretrained.backbones import vgg_preprocess_caffe
from dip_tpu_torch.pretrained.matcher import Matcher
from dip_tpu_torch.tasks.base import TaskSpec
from dip_tpu_torch.tasks.feature_inversion import build_extractor, inversion_net


def task(
    backbone: str = "alexnet_caffe",
    layer: str = "conv4",
    map_idx: int = 2,
    window_size: int = 20,
    weights_path: str | None = None,
    method: str | None = None,          # default: fc8 -> 'am_match', else 'maximize'
    num_iter: int = 3100,
    lr: float | None = None,
    tv_weight: float = 0.0,
    mask_nhwc=None,                      # penalize output inside this mask
    imsize_net: int = 256,
    imsize: int | None = None,
    input_depth: int = 32,
    *,
    device: torch.device | str = "cuda",
    generator: torch.Generator | None = None,
) -> TaskSpec:
    """The activation-maximization TaskSpec; the backbone (weights from
    `generator`, see build_extractor) and the mask live on `device`, where
    the fit must run."""
    extract, model, imsize = build_extractor(backbone, (layer,), weights_path, imsize=imsize,
                                             device=device, generator=generator)
    if method is None:
        method = "am_match" if layer == "fc8" else "maximize"
    if lr is None:
        lr = 1e-2 if layer == "fc8" else 1e-3

    matcher = Matcher(how="features", method=method, map_index=map_idx,
                      window_size=window_size)
    dev = next(model.parameters()).device
    mask = None if mask_nhwc is None else torch.as_tensor(
        np.asarray(mask_nhwc, dtype=np.float32)).to(dev)

    def loss_fn(p, out, aux):
        out_c = out[:, :imsize, :imsize, :]
        total = matcher.total(extract(out_c)) * 5.0
        if tv_weight > 0:
            total = total + tv_weight * tv_loss(vgg_preprocess_caffe(out_c), beta=2.0)
        if mask is not None:
            d = out_c * mask
            total = total + torch.sum(d * d) * 1e1
        return total

    return TaskSpec(
        name=f"activation_max/{layer}[{map_idx}]",
        model=inversion_net(pad="reflection", num_input_channels=input_depth),
        cfg=FitConfig(num_iter=num_iter, lr=lr, reg_noise_std=0.03, param_noise=True),
        loss_fn=loss_fn,
        aux={},
        input_depth=input_depth,
        spatial_size=(imsize_net, imsize_net),
        postprocess=lambda out: out[:, :imsize, :imsize, :],
    )
