"""Frozen classifier backbones, the feature matcher, the perceptual loss and
local torch-checkpoint loading (counterpart of dip_tpu/pretrained)."""

from dip_tpu_torch.pretrained.backbones import (VGG, AlexNet, get_backbone, pytorch_preprocess,
                                                vgg_preprocess_caffe)
from dip_tpu_torch.pretrained.convert import convert_torch_state_dict, load_torch_weights
from dip_tpu_torch.pretrained.matcher import Matcher

__all__ = [
    "VGG",
    "AlexNet",
    "get_backbone",
    "vgg_preprocess_caffe",
    "pytorch_preprocess",
    "Matcher",
    "load_torch_weights",
    "convert_torch_state_dict",
]
