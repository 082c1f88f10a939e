"""PerceptualLoss: one-call deep-feature distance (counterpart of
dip_tpu/pretrained/perceptual.py): store statistics from the target image,
match them on the prediction, sum over matchers. A plain callable,
loss = PerceptualLoss(...)(x, y), usable inside a fit's loss.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dip_tpu_torch.pretrained.backbones import pytorch_preprocess, vgg_preprocess_caffe
from dip_tpu_torch.pretrained.matcher import Matcher
from dip_tpu_torch.tasks.feature_inversion import build_extractor

_PREPROCESS = {
    "alexnet_caffe": vgg_preprocess_caffe,
    "vgg19_caffe": vgg_preprocess_caffe,
    "vgg16_caffe": vgg_preprocess_caffe,
    "vgg19_pytorch_modified": pytorch_preprocess,
}


class PerceptualLoss:
    """Deep-feature distance between images in [0,1] ('sigmoid') or
    [-1,1] ('tanh').

    match: list of dicts {'layers': (...names...), 'what': 'features' |
    'gram_matrix', 'loss': 'mse' | 'L1' | 'smoothL1'}, one Matcher per
    entry, losses summed. The backbone is built on `device` with weights
    from `generator` (see build_extractor).
    """

    def __init__(
        self,
        net_type: str = "vgg19_caffe",
        match: Sequence[dict] = ({"layers": ("relu4_4",), "what": "features"},),
        weights_path: str | None = None,
        input_range: str = "sigmoid",
        imsize: int | None = None,
        *,
        device: torch.device | str = "cuda",
        generator: torch.Generator | None = None,
    ):
        all_layers = tuple({l for m in match for l in m["layers"]})  # noqa: E741
        self.extract, self.backbone, self.imsize = build_extractor(
            net_type, all_layers, weights_path, imsize=imsize,
            preprocess=_PREPROCESS[net_type], device=device, generator=generator)
        self.input_range = input_range
        self.matchers = [
            (tuple(m["layers"]),
             Matcher(how=m.get("what", "features"), loss=m.get("loss", "mse"),
                     method="match"))
            for m in match
        ]

    def _acts(self, x: torch.Tensor) -> dict:
        if self.input_range == "tanh":
            x = (x + 1.0) / 2.0
        return self.extract(x)

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Sum of feature-statistic distances between x and target y."""
        acts_y = self._acts(y)
        acts_x = self._acts(x)
        total = torch.zeros((), device=x.device)
        for layers, matcher in self.matchers:
            stored = matcher.store({k: acts_y[k] for k in layers})
            total = total + matcher.total({k: acts_x[k] for k in layers}, stored)
        return total
