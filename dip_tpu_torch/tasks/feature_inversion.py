"""Feature inversion: reconstruct an image whose deep features match a
content image's (counterpart of dip_tpu/tasks/feature_inversion.py).

The frozen backbone (pretrained/backbones.py) lives in the loss closure,
not in TaskSpec.model: it is built on the fit's device, and the content's
stored statistics go in `aux`. The gradient flows through it into the
generator. Recipe: a 6-scale skip net (filters [7,7,5,5,3,3], avg
downsampling, nearest up, zero pad), z at 256^2, the output cropped to the
classifier's input size (227 AlexNet / 224 VGG), caffe preprocessing, 3100
Adam steps at lr 1e-3. In bf16 the engine casts the render back to f32
before the loss, so the backbone runs in f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dip_tpu_torch.fit.engine import FitConfig, resolve_device
from dip_tpu_torch.models import Skip
from dip_tpu_torch.pretrained.backbones import default_imsize, get_backbone, vgg_preprocess_caffe
from dip_tpu_torch.pretrained.convert import apply_converted, load_torch_weights
from dip_tpu_torch.pretrained.matcher import Matcher
from dip_tpu_torch.tasks.base import TaskSpec


def inversion_net(num_output_channels: int = 3, pad: str = "zero",
                  num_input_channels: int = 32) -> Skip:
    """The notebook's 6-scale generator (cell 11), for z of
    `num_input_channels` channels."""
    return Skip(
        num_input_channels=num_input_channels,
        num_output_channels=num_output_channels,
        num_channels_down=[16, 32, 64, 128, 128, 128],
        num_channels_up=[16, 32, 64, 128, 128, 128],
        num_channels_skip=[4] * 6,
        filter_size_down=[7, 7, 5, 5, 3, 3],
        filter_size_up=[7, 7, 5, 5, 3, 3],
        upsample_mode="nearest",
        downsample_mode="avg",
        need_sigmoid=True,
        pad=pad,
    )


def build_extractor(backbone: str = "alexnet_caffe",
                    layers: tuple[str, ...] = ("fc6",),
                    weights_path: str | None = None,
                    imsize: int | None = None,
                    preprocess=None, *,
                    device: torch.device | str = "cuda",
                    generator: torch.Generator | None = None):
    """Return (extract_fn, backbone, imsize). extract_fn(x_rgb01) -> dict
    of tapped activations after preprocessing (caffe BGR by default). The
    backbone's weights are drawn from `generator` (a CPU generator; None:
    one seeded 0, as the JAX package inits from key 0), then overlaid from
    the local torch checkpoint `weights_path` if given (which must exist),
    and the backbone is moved to `device` (raises if that is CUDA and there
    is none)."""
    if imsize is None:
        imsize = default_imsize(backbone)
    if preprocess is None:
        preprocess = vgg_preprocess_caffe
    dev = resolve_device(device)
    model = get_backbone(backbone, imsize)
    model.reset_parameters(torch.Generator().manual_seed(0) if generator is None else generator)
    if weights_path:
        converted = load_torch_weights(weights_path)
        if converted is None:
            raise FileNotFoundError(f"no torch checkpoint at {weights_path!r}")
        apply_converted(model, converted)
    model.to(dev)

    def extract(x_rgb01: torch.Tensor) -> dict:
        return model(preprocess(x_rgb01), taps=layers)

    return extract, model, imsize


class FeatureInversion:
    """Bundles extractor + matcher + generator + fit recipe.

    Not a TaskSpec because it needs a store pass on the content image
    before fitting; `spec(content_img)` runs the store on the backbone's
    device and returns the TaskSpec.
    """

    def __init__(self, backbone: str = "alexnet_caffe",
                 layers: tuple[str, ...] = ("fc6",),
                 what: str = "features",
                 weights_path: str | None = None,
                 imsize_net: int = 256,
                 imsize: int | None = None,
                 num_iter: int = 3100, lr: float = 1e-3, *,
                 device: torch.device | str = "cuda",
                 generator: torch.Generator | None = None):
        self.extract, self.backbone, self.imsize = build_extractor(
            backbone, layers, weights_path, imsize=imsize, device=device, generator=generator)
        self.device = next(self.backbone.parameters()).device
        self.matcher = Matcher(how=what, loss="mse", method="match")
        self.imsize_net = imsize_net
        self.num_iter = num_iter
        self.lr = lr

    def spec(self, content_img_nhwc, input_depth: int = 32) -> TaskSpec:
        content = torch.as_tensor(np.asarray(content_img_nhwc, dtype=np.float32))
        if not content.shape[1] == content.shape[2] == self.imsize:
            raise ValueError(f"content image must be {self.imsize}^2, got "
                             f"{tuple(content.shape[1:3])}")
        with torch.no_grad():
            stored = self.matcher.store(self.extract(content.to(self.device)))
        sz = self.imsize

        def loss_fn(p, out, aux):
            return self.matcher.total(self.extract(out[:, :sz, :sz, :]), aux["stored"])

        return TaskSpec(
            name="feature_inversion",
            model=inversion_net(num_input_channels=input_depth),
            cfg=FitConfig(num_iter=self.num_iter, lr=self.lr),
            loss_fn=loss_fn,
            aux={"stored": stored},
            input_depth=input_depth,
            spatial_size=(self.imsize_net, self.imsize_net),
            postprocess=lambda out: out[:, :sz, :sz, :],
        )


def task(content_img_nhwc, backbone: str = "alexnet_caffe",
         layers: tuple[str, ...] = ("fc6",), weights_path: str | None = None,
         **kw) -> TaskSpec:
    return FeatureInversion(backbone, layers, weights_path=weights_path,
                            **kw).spec(content_img_nhwc)


def big_run_spec(fi: FeatureInversion, content_img_nhwc, input_depth: int = 2) -> TaskSpec:
    """The 20k-iteration staged-noise variant (feature_inversion.ipynb cells
    20-22): a 2-channel input, lr 0.01, input jitter x10 until 10k, x2
    until 15k, x0.5 until 20k, with weight jitter."""
    spec = fi.spec(content_img_nhwc, input_depth=input_depth)
    cfg = dataclasses.replace(
        spec.cfg,
        num_iter=20000,
        lr=0.01,
        param_noise=True,
        reg_noise_schedule=((10000, 10.0), (15000, 2.0), (20000, 0.5)),
    )
    return dataclasses.replace(spec, cfg=cfg)
