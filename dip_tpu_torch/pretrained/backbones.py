"""Frozen classifier backbones with feature taps, NHWC in (counterpart of
dip_tpu/pretrained/backbones.py).

`forward(x, taps)` returns a dict of the tapped activations by the
reference's caffe-style layer names ('conv1_1'...'fc8' for VGG, 'conv1'...
'softmax' for AlexNet-caffe): NHWC for conv and pool taps, (N, F) for fc
taps. It stops at the deepest tap. Every parameter is frozen
(requires_grad=False): a fit differentiates through the backbone into the
generator and computes no weight gradient here.

The layers are named as the flax modules name theirs, so a layer's flax
params {'kernel', 'bias'} map onto `<name>.weight` / `<name>.bias`
(interop.py) and a torch checkpoint's caffe-style keys load directly
(convert.py). A torch Linear needs its input width at construction, where
flax's Dense infers it, so the backbones take `imsize`, the input size the
fc6 width follows from. Before the fc layers the activation is flattened
in NCHW order, as torch flattens, so torchvision and caffe fc weights line
up unchanged.

Weights: `reset_parameters(generator)` draws the JAX package's init (the
convs torch-style uniform, the Dense layers lecun_normal, zero biases) on
the CPU; convert.py overlays a local torch checkpoint. Nothing is
downloaded.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dip_tpu_torch.ops.consts import device_const
from dip_tpu_torch.ops.resample import avg_pool, max_pool

# --- preprocessing ----------------------------------------------------------

_VGG_MEAN_BGR = (103.939, 116.779, 123.680)
_MEAN_TORCH = (0.485, 0.456, 0.406)
_STD_TORCH = (0.229, 0.224, 0.225)


def _vec(values: tuple) -> np.ndarray:
    return np.asarray(values, np.float64)


def _const(values: tuple, like: torch.Tensor) -> torch.Tensor:
    return device_const(_vec, values, like.dtype, like.device)


def vgg_preprocess_caffe(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0,1] NHWC -> caffe BGR * 255 - mean."""
    return rgb.flip(-1) * 255.0 - _const(_VGG_MEAN_BGR, rgb)


def vgg_deprocess_caffe(bgr: torch.Tensor) -> torch.Tensor:
    rgb = ((bgr + _const(_VGG_MEAN_BGR, bgr)) / 255.0).flip(-1)
    return torch.clamp(rgb, 0.0, 1.0)


def pytorch_preprocess(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - _const(_MEAN_TORCH, rgb)) / _const(_STD_TORCH, rgb)


# --- layer tables -----------------------------------------------------------

# (name, kind, arg): conv -> out channels; pool -> 2x2/s2; fc -> width
VGG19_LAYERS = [
    ("conv1_1", "conv", 64), ("conv1_2", "conv", 64), ("pool1", "pool", 0),
    ("conv2_1", "conv", 128), ("conv2_2", "conv", 128), ("pool2", "pool", 0),
    ("conv3_1", "conv", 256), ("conv3_2", "conv", 256),
    ("conv3_3", "conv", 256), ("conv3_4", "conv", 256), ("pool3", "pool", 0),
    ("conv4_1", "conv", 512), ("conv4_2", "conv", 512),
    ("conv4_3", "conv", 512), ("conv4_4", "conv", 512), ("pool4", "pool", 0),
    ("conv5_1", "conv", 512), ("conv5_2", "conv", 512),
    ("conv5_3", "conv", 512), ("conv5_4", "conv", 512), ("pool5", "pool", 0),
    ("fc6", "fc", 4096), ("fc7", "fc", 4096), ("fc8", "fc", 1000),
]

VGG16_LAYERS = [
    ("conv1_1", "conv", 64), ("conv1_2", "conv", 64), ("pool1", "pool", 0),
    ("conv2_1", "conv", 128), ("conv2_2", "conv", 128), ("pool2", "pool", 0),
    ("conv3_1", "conv", 256), ("conv3_2", "conv", 256),
    ("conv3_3", "conv", 256), ("pool3", "pool", 0),
    ("conv4_1", "conv", 512), ("conv4_2", "conv", 512),
    ("conv4_3", "conv", 512), ("pool4", "pool", 0),
    ("conv5_1", "conv", 512), ("conv5_2", "conv", 512),
    ("conv5_3", "conv", 512), ("pool5", "pool", 0),
    ("fc6", "fc", 4096), ("fc7", "fc", 4096), ("fc8", "fc", 1000),
]

ALEXNET_TAPS = ["conv1", "relu1", "norm1", "pool1",
                "conv2", "relu2", "norm2", "pool2",
                "conv3", "relu3", "conv4", "relu4", "conv5", "relu5", "pool5",
                "fc6", "relu6", "fc7", "relu7", "fc8", "softmax"]


# --- layers -----------------------------------------------------------------

def _frozen(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class BackboneConv(nn.Module):
    """A frozen conv, NHWC in and out, OIHW weight (grouped: (O, I/groups,
    k, k), the flax kernel (k, k, I/groups, O) transposed)."""

    def __init__(self, in_channels: int, features: int, ksize: int = 3, stride: int = 1,
                 pad: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.pad, self.groups = stride, pad, groups
        self.weight = _frozen(features, in_channels // groups, ksize, ksize)
        self.bias = _frozen(features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's torch_conv_kernel_init: U(-b, b) with b =
        1/sqrt(k*k*I/groups), drawn on the CPU; zero bias."""
        w = self.weight
        bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
        with torch.no_grad():
            w.copy_(torch.empty(w.shape).uniform_(-bound, bound, generator=generator))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride, self.pad,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], by redrawing the values outside (about
    one in 22; nn.init.trunc_normal_'s inverse-CDF draw is ten times slower
    on a CPU core, which matters at fc6's 10^8 weights)."""
    w = torch.empty(shape).normal_(generator=generator).reshape(-1)
    idx = torch.nonzero(w.abs() > 2.0).squeeze(1)
    while idx.numel():
        v = torch.empty(idx.numel()).normal_(generator=generator)
        w[idx] = v
        idx = idx[v.abs() > 2.0]
    return w.reshape(shape)


class BackboneDense(nn.Module):
    """A frozen fully connected layer, (out, in) weight."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = _frozen(features, in_features)
        self.bias = _frozen(features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's lecun_normal: a normal truncated at two deviations, its
        deviation scaled so that the variance is 1/in, drawn on the CPU;
        zero bias."""
        std = math.sqrt(1.0 / self.weight.shape[1]) / 0.87962566103423978
        with torch.no_grad():
            self.weight.copy_(_truncated_normal(self.weight.shape, generator) * std)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def _flatten_nchw(h: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C*H*W) in torch's NCHW flatten order."""
    return h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)


class LRN(nn.Module):
    """Local response normalization across channels (caffe AlexNet):
    x * (k + alpha * sum of x^2 over a window of `size` channels)^-beta,
    with no 1/size on alpha (F.local_response_norm divides alpha by size)."""

    def __init__(self, size: int = 5, alpha: float = 1e-4, beta: float = 0.75,
                 k: float = 1.0):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, half = x.shape[-1], self.size // 2
        padded = F.pad(x * x, (half, half))
        window = sum(padded[..., i:i + c] for i in range(self.size))
        return x * torch.pow(self.k + self.alpha * window, -self.beta)


class Backbone(nn.Module):
    """The shared part of the backbones: the frozen layers' init."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every layer's weights from `generator` (a CPU generator, so
        every device gets the same weights), in the order of the layers."""
        for m in self.children():
            if isinstance(m, (BackboneConv, BackboneDense)):
                m.reset_parameters(generator)


class VGG(Backbone):
    """VGG19/VGG16 with caffe-style naming and feature taps.

    forward(x_preprocessed, taps=('fc6',)) -> dict name -> activation.
    ReLUs follow every conv/fc except fc8 ('reluN_M', 'relu6', 'relu7' taps
    are exposed too). leaky_slope and avg_pool_instead make the
    'vgg19_pytorch_modified' variant (LeakyReLU, average pools).
    """

    def __init__(self, depth: int = 19, leaky_slope: float = 0.0,
                 avg_pool_instead: bool = False, imsize: int = 224):
        super().__init__()
        self.layers = VGG19_LAYERS if depth == 19 else VGG16_LAYERS
        self.leaky_slope = leaky_slope
        self.avg_pool_instead = avg_pool_instead
        cin, size = 3, imsize
        for name, kind, arg in self.layers:
            if kind == "conv":
                self.add_module(name, BackboneConv(cin, arg))
                cin = arg
            elif kind == "pool":
                size //= 2
            else:
                self.add_module(name, BackboneDense(cin * size * size, arg))
                cin, size = arg, 1

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        return F.relu(h) if self.leaky_slope == 0 else F.leaky_relu(h, self.leaky_slope)

    def forward(self, x: torch.Tensor, taps: Sequence[str] = ("fc6",)) -> dict:
        taps = tuple(taps)
        last = self._deepest(self.layers, taps)
        acts: dict[str, torch.Tensor] = {}
        h = x
        for name, kind, _ in self.layers[:last + 1]:
            if kind == "conv":
                h = getattr(self, name)(h)
                acts[name] = h
                h = self._act(h)
                acts["relu" + name[4:]] = h
            elif kind == "pool":
                h = avg_pool(h, 2) if self.avg_pool_instead else max_pool(h, 2)
                acts[name] = h
            else:
                if h.dim() == 4:
                    h = _flatten_nchw(h)
                h = getattr(self, name)(h)
                acts[name] = h
                if name != "fc8":
                    h = F.relu(h)
                    acts["relu" + name[2:]] = h
        return {t: acts[t] for t in taps}

    @staticmethod
    def _deepest(layers, taps) -> int:
        """The index in `layers` of the deepest tap (a 'relu...' tap at its
        conv or fc layer); raises for an unknown tap."""
        names = [n for n, _, _ in layers]
        idx = []
        for t in taps:
            if t in names:
                idx.append(names.index(t))
            elif t.startswith("relu"):
                base = "conv" + t[4:] if not t[4:].startswith(("6", "7")) else "fc" + t[4:]
                idx.append(names.index(base))
            else:
                raise ValueError(f"unknown tap {t!r}")
        return max(idx)


class AlexNet(Backbone):
    """Caffe AlexNet (CaffeNet) with grouped convs and LRN, tapped by name.
    The pools are VALID 3x3 stride-2 max pools (floor), as the JAX package
    takes them."""

    def __init__(self, imsize: int = 227):
        super().__init__()
        self.conv1 = BackboneConv(3, 96, ksize=11, stride=4, pad=0)
        self.conv2 = BackboneConv(96, 256, ksize=5, pad=2, groups=2)
        self.conv3 = BackboneConv(256, 384)
        self.conv4 = BackboneConv(384, 384, groups=2)
        self.conv5 = BackboneConv(384, 256, groups=2)
        size = (imsize - 11) // 4 + 1
        for _ in range(3):  # pool1, pool2, pool5; the convs between keep the size
            size = (size - 3) // 2 + 1
        self.fc6 = BackboneDense(256 * size * size, 4096)
        self.fc7 = BackboneDense(4096, 4096)
        self.fc8 = BackboneDense(4096, 1000)
        self.norm = LRN()

    def _stages(self):
        """(tap name, the function that makes it from the last) in order."""
        pool = functools.partial(max_pool, window=3, stride=2)
        return [("conv1", self.conv1), ("relu1", F.relu), ("norm1", self.norm),
                ("pool1", pool), ("conv2", self.conv2), ("relu2", F.relu),
                ("norm2", self.norm), ("pool2", pool), ("conv3", self.conv3),
                ("relu3", F.relu), ("conv4", self.conv4), ("relu4", F.relu),
                ("conv5", self.conv5), ("relu5", F.relu), ("pool5", pool),
                ("fc6", lambda h: self.fc6(_flatten_nchw(h))), ("relu6", F.relu),
                ("fc7", self.fc7), ("relu7", F.relu), ("fc8", self.fc8),
                ("softmax", lambda h: torch.softmax(h, -1))]

    def forward(self, x: torch.Tensor, taps: Sequence[str] = ("fc6",)) -> dict:
        taps = tuple(taps)
        last = max(ALEXNET_TAPS.index(t) for t in taps)
        acts: dict[str, torch.Tensor] = {}
        h = x
        for name, fn in self._stages()[:last + 1]:
            h = fn(h)
            acts[name] = h
        return {t: acts[t] for t in taps}


def default_imsize(name: str) -> int:
    """The classifier's input size: 227 for AlexNet, 224 for VGG."""
    return 227 if name.startswith("alexnet") else 224


def get_backbone(name: str, imsize: int | None = None) -> Backbone:
    """'alexnet_caffe' | 'vgg19_caffe' | 'vgg16_caffe' |
    'vgg19_pytorch_modified', for inputs of imsize^2 (default_imsize by
    default). Its weights are drawn by reset_parameters."""
    size = default_imsize(name) if imsize is None else imsize
    if name == "alexnet_caffe":
        return AlexNet(imsize=size)
    if name == "vgg19_caffe":
        return VGG(depth=19, imsize=size)
    if name == "vgg16_caffe":
        return VGG(depth=16, imsize=size)
    if name == "vgg19_pytorch_modified":
        return VGG(depth=19, leaky_slope=0.2, avg_pool_instead=True, imsize=size)
    raise ValueError(f"unknown backbone {name!r}")
