"""Torch checkpoints for the backbones (counterpart of
dip_tpu/pretrained/convert.py).

`load_torch_weights` reads a local `.pth` the user already has: a state
dict (or a pickled module) whose keys follow the caffe-style naming
('conv1_1.weight', 'fc6.bias', ...) or torchvision's VGG layout
('features.N.weight', 'classifier.N.weight'). The keys become layer names;
the tensors keep their layout, which is already the port's (OIHW convs,
(out, in) fc weights). `apply_converted` overlays them onto a backbone.
Nothing is downloaded.
"""

from __future__ import annotations

import os
from typing import Mapping

import torch

from dip_tpu_torch.pretrained.backbones import Backbone, BackboneConv, BackboneDense

# torchvision vgg feature indices -> caffe-style names
_VGG19_IDX = {
    0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3", 16: "conv3_4",
    19: "conv4_1", 21: "conv4_2", 23: "conv4_3", 25: "conv4_4",
    28: "conv5_1", 30: "conv5_2", 32: "conv5_3", 34: "conv5_4",
}
_VGG16_IDX = {
    0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
    24: "conv5_1", 26: "conv5_2", 28: "conv5_3",
}
_CLASSIFIER_IDX = {0: "fc6", 3: "fc7", 6: "fc8"}


def _detect_vgg_layout(state: Mapping[str, object]) -> dict:
    """VGG16 and VGG19 torchvision layouts share feature indices 0-16 but
    diverge above (16/25/30/32/34 are VGG19-only; 17 is VGG16-only), so the
    index set identifies the architecture."""
    idxs = {int(k.split(".")[1]) for k in state
            if k.startswith("features.") and k.split(".")[1].isdigit()}
    if idxs & {16, 25, 30, 32, 34}:
        return _VGG19_IDX
    if 17 in idxs:
        return _VGG16_IDX
    return _VGG19_IDX  # indices <= 14 are identical in both


def convert_torch_state_dict(state: Mapping[str, object]) -> dict[str, dict[str, torch.Tensor]]:
    """A torch state dict (tensor or array values) with caffe-style or
    torchvision-style keys -> {layer name: {'weight', 'bias'}} as f32 CPU
    tensors in their own layout."""
    out: dict[str, dict[str, torch.Tensor]] = {}
    vgg_idx = _detect_vgg_layout(state)
    for key, val in state.items():
        parts = key.split(".")
        if parts[0] == "features" and len(parts) == 3:
            name = vgg_idx.get(int(parts[1]))
        elif parts[0] == "classifier" and len(parts) == 3:
            name = _CLASSIFIER_IDX.get(int(parts[1]))
        else:
            name = parts[0]
        if name is None:
            continue
        t = torch.as_tensor(val).detach().to("cpu", torch.float32)
        out.setdefault(name, {})[parts[-1]] = t
    return out


def load_torch_weights(path: str) -> dict | None:
    """Load and convert the torch checkpoint at `path` if it exists; else
    None. It is unpickled in full (`weights_only=False`, as the JAX package
    loads it), so give it only a file you trust."""
    if not os.path.exists(path):
        return None
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return convert_torch_state_dict(obj)


def apply_converted(backbone: Backbone, converted: dict) -> Backbone:
    """Copy the converted weights into `backbone`'s layers of the same
    name, leaf by leaf where the shapes agree (others are skipped, as the
    JAX package skips them); returns the backbone."""
    with torch.no_grad():
        for name, leaves in converted.items():
            layer = getattr(backbone, name, None)
            if not isinstance(layer, (BackboneConv, BackboneDense)):
                continue
            for leaf, t in leaves.items():
                p = getattr(layer, leaf, None)
                if isinstance(p, torch.Tensor) and tuple(p.shape) == tuple(t.shape):
                    p.copy_(t)
    return backbone
