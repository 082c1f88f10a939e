"""Building blocks of the generator zoo, NHWC at every public function.

Counterpart of dip_tpu/models/blocks.py. Convolution weights are OIHW
(PyTorch's layout); activations stay NHWC, and a contiguous NHWC tensor
`.permute(0, 3, 1, 2)` is an NCHW tensor in channels_last memory, which
F.conv2d takes without a copy. BatchNorm is always in train mode and keeps
no running statistics: DIP fits one image, so batch statistics are the
image's statistics.

Conv (its Lanczos post-down included), ConvTranspose, TrainBatchNorm,
InstanceNorm, GenNoise, `act` and the crops take row blocks (ops/rows.Rows)
where they take a tensor, for parallel/spatial.py: a padded conv and a
transposed conv read their halo rows from the neighbouring blocks, the
norms' moments sum over all of them, and the noise is drawn for the whole
image and cut into the blocks' rows.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dip_tpu_torch.ops import hopper_wgrad
from dip_tpu_torch.ops.pad import _MODES, pad2d
from dip_tpu_torch.ops.resample import avg_pool, downsample, max_pool
from dip_tpu_torch.ops.rows import Rows, cat_channels, cut_rows, gather_rows, halo_blocks
from dip_tpu_torch.ops.up_conv import Up2, up2_conv3x3, up2_moments
from dip_tpu_torch.utils.profiling import span

# which convs take their weight gradient from the Hopper kernels (the JAX
# package's DIP_PALLAS_WGRAD '0' | '1x1' | '3x3' | '1'/'all')
CONV_WGRAD = ("off", "1x1", "3x3", "all")
POST_DOWN = ("avg", "max", "lanczos2", "lanczos3")


def check_conv_wgrad(mode: str) -> str:
    if mode not in CONV_WGRAD:
        raise ValueError(f"conv_wgrad {mode!r} is not one of {CONV_WGRAD}")
    return mode


def torch_conv_init_(weight: torch.Tensor, bias: torch.Tensor | None,
                     generator: torch.Generator, fan_in: int | None = None) -> None:
    """PyTorch's Conv2d default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the
    kernel and the bias, drawn on the CPU so that init is the same on every
    device. fan_in defaults to an OIHW weight's I*H*W."""
    if fan_in is None:
        fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        for p in (weight, bias):
            if p is not None:
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))


def act(x: torch.Tensor | Rows, act_fun: str | Callable = "LeakyReLU"):
    with span("dip.model.act"):
        if isinstance(x, Rows):
            return x.map(lambda b: act(b, act_fun))
        if callable(act_fun):
            return act_fun(x)
        if act_fun == "LeakyReLU":
            return F.leaky_relu(x, 0.2)
        if act_fun == "Swish":
            return x * torch.sigmoid(x)
        if act_fun == "ELU":
            return F.elu(x)
        if act_fun == "ReLU":
            return F.relu(x)
        if act_fun == "none":
            return x
        raise ValueError(f"unknown activation {act_fun!r}")


def _moments(p: torch.Tensor | Up2) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, var) over (N, H, W): one pass of sum and sum of
    squares with f32 sums, returned in p's dtype. Up2 parts take their HR
    moments from the LR tensor."""
    if isinstance(p, Up2):
        return up2_moments(p.x, p.mode)
    m = p.shape[0] * p.shape[1] * p.shape[2]
    pf = p.to(torch.float32)
    mean = pf.sum((0, 1, 2)) / m
    var = torch.clamp((pf * pf).sum((0, 1, 2)) / m - mean * mean, min=0.0)
    return mean.to(p.dtype), var.to(p.dtype)


class TrainBatchNorm(nn.Module):
    """Affine batch norm by current batch statistics (BatchNorm2d in
    training mode, without running averages).

    Takes a tensor or a list of NHWC parts standing for their channel
    concat: each part is normalised with its slice of the full-width
    weight and bias, which equals BN of the concat without building it.
    `as_affine=True` returns (x, s, t) with BN(x) == x * s + t per channel,
    for a following Conv to fold in.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def _affine(self, p, off: int):
        ci = p.shape[-1]
        mean, var = _moments(p)
        s = torch.rsqrt(var + self.eps) * self.weight[off:off + ci]
        t = -mean * s + self.bias[off:off + ci]
        return s, t

    def forward(self, x, as_affine: bool = False):
        with span("dip.model.bn"):
            parts = isinstance(x, (list, tuple))
            xs = list(x) if parts else [x]
            if as_affine:
                ss, ts, off = [], [], 0
                for p in xs:
                    s, t = self._affine(p, off)
                    ss.append(s)
                    ts.append(t)
                    off += p.shape[-1]
                return x, torch.cat(ss), torch.cat(ts)
            out, off = [], 0
            for p in xs:
                ci = p.shape[-1]
                if isinstance(p, Up2):
                    s, t = self._affine(p, off)
                    y = p.affine(s, t)
                else:
                    mean, var = _moments(p)
                    y = (p - mean) * torch.rsqrt(var + self.eps)
                    y = y * self.weight[off:off + ci] + self.bias[off:off + ci]
                out.append(y)
                off += ci
            return out if parts else out[0]


class InstanceNorm(nn.Module):
    """Per image and channel normalisation over (H, W), without an affine
    map (InstanceNorm2d's defaults, UNet's norm layer). The moments are
    two-pass f32; the result has x's dtype."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor | Rows):
        with span("dip.model.bn"):
            if isinstance(x, Rows):
                # the blocks' sums, added on block 0's device: the mean, then the
                # centred second moment, each (N, 1, 1, C)
                n, h, w, c = x.shape
                xf = x.to(torch.float32)
                mean = (xf.sum((1, 2)) / (h * w)).view(n, 1, 1, c)
                d = xf - mean
                var = ((d * d).sum((1, 2)) / (h * w)).view(n, 1, 1, c)
                return (d * torch.rsqrt(var + self.eps)).to(x.dtype)
            xf = x.float()
            var, mean = torch.var_mean(xf, dim=(1, 2), correction=0, keepdim=True)
            return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


def norm(kind: str | None, features: int) -> nn.Module:
    """The norm layer of `kind` ('batch', 'instance', or None / 'none' for
    none) over `features` channels."""
    if kind in (None, "none"):
        return nn.Identity()
    if kind == "batch":
        return TrainBatchNorm(features)
    if kind == "instance":
        return InstanceNorm()
    raise ValueError(f"unknown norm {kind!r}")


def _conv2d(x: torch.Tensor, weight: torch.Tensor, stride: int,
            padding: int, wgrad: str = "off") -> torch.Tensor:
    """NHWC in, NHWC out, OIHW weight. With `wgrad` on for its kind, a
    stride-1 3x3 conv (padding 1, or 0 on a pre-padded input) or a 1x1 conv
    takes its weight gradient from a Hopper kernel (ops/hopper_wgrad.py);
    every other conv is cuDNN's, as conv2d_fast routes in the JAX package."""
    ks = weight.shape[-1]
    if stride == 1 and ks == 3 and padding in (0, 1) and wgrad in ("3x3", "all"):
        return hopper_wgrad.conv3x3_s1(x, weight, padding)
    if stride == 1 and ks == 1 and padding == 0 and wgrad in ("1x1", "all"):
        return hopper_wgrad.conv1x1(x, weight)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, padding)
    return y.permute(0, 2, 3, 1)


def _pad_conv(x: torch.Tensor | Rows, weight: torch.Tensor, stride: int, to_pad: int,
              pad: str, wgrad: str):
    """conv of x padded by `to_pad` on each side as `pad` pads. Over row
    blocks, each block takes `to_pad` halo rows (the pad's own rows past
    the image's true top and bottom), is padded along W, and runs a VALID
    conv: a stride-2 window starts on the block's first row, which is even
    wherever the block heights are."""
    if isinstance(x, Rows):
        if to_pad == 0:
            return x.map(lambda b: _conv2d(b, weight.to(b.device), stride, 0, wgrad))
        if pad not in _MODES:
            raise ValueError(f"unknown pad mode {pad!r}")
        return Rows([_conv2d(pad2d(xr, (0, to_pad), pad), weight.to(xr.device), stride, 0,
                             wgrad)
                     for xr in halo_blocks(x, to_pad, to_pad, _MODES[pad])])
    if pad in ("reflection", "replication") and to_pad > 0:
        return _conv2d(pad2d(x, to_pad, pad), weight, stride, 0, wgrad)
    return _conv2d(x, weight, stride, to_pad, wgrad)


class Conv(nn.Module):
    """Padded conv; takes a tensor or a list of NHWC parts (a virtual
    channel concat: conv(concat(parts), W) == sum_i conv(part_i, W_i)).
    With stride > 1 and a downsample_mode other than 'stride', the conv
    runs at stride 1 and is followed by avg or max pooling or a fixed
    Lanczos downsample (the reference's conv()).

    `in_scale`/`in_shift` fold a preceding per-channel affine map (a BN
    from TrainBatchNorm(as_affine=True)) into the conv:
    conv(x*s + t, W) == conv(x, W*s) + sum_hwi W[:, i, h, w] * t[i], exact
    for reflection/replication padding and for 1x1 convs. Up2 parts go to
    the fused seam, up2_conv3x3; with `seam_carry` the parts summed before an
    Up2 part (the decoder's skip-branch conv) enter the seam as its carry-in.
    `conv_wgrad` (one of CONV_WGRAD) routes the stride-1 3x3 and the 1x1
    convs' weight gradients through the Hopper kernels.
    """

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, bias: bool = True, pad: str = "zero",
                 downsample_mode: str = "stride"):
        super().__init__()
        if downsample_mode not in ("stride", *POST_DOWN):
            raise ValueError(f"unknown downsample_mode {downsample_mode!r}")
        self.kernel_size = kernel_size
        self.stride = stride
        self.post_down = None if stride == 1 or downsample_mode == "stride" else downsample_mode
        self.pad = pad
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_conv_init_(self.weight, self.bias, generator)

    def forward(self, x, in_scale: torch.Tensor | None = None,
                in_shift: torch.Tensor | None = None,
                seam_carry: bool = False, conv_wgrad: str = "off") -> torch.Tensor:
        with span("dip.model.conv"):
            ks = self.kernel_size
            stride = 1 if self.post_down else self.stride
            wgrad = check_conv_wgrad(conv_wgrad)
            if in_scale is not None and ks > 1 and self.pad not in (
                    "reflection", "replication"):
                raise ValueError(
                    "affine folding into a zero-padded k>1 conv is not exact "
                    "(padded zeros lack the shift); materialize the BN instead")
            to_pad = (ks - 1) // 2
            parts_in = isinstance(x, (list, tuple))
            xs = list(x) if parts_in else [x]
            kernel = self.weight
            y, off = None, 0
            for p in xs:
                ci = p.shape[-1]
                kp = kernel[:, off:off + ci] if parts_in else kernel
                if in_scale is not None:
                    kp = kp * in_scale[off:off + ci].to(kp.dtype)[None, :, None, None]
                if isinstance(p, Up2):
                    if ks != 3 or stride != 1:
                        raise ValueError(f"Up2 parts need a 3x3 stride-1 conv, got {ks}, {stride}")
                    if seam_carry and y is not None:
                        y = up2_conv3x3(p.x, kp.permute(2, 3, 1, 0), p.mode, self.pad, carry=y)
                        off += ci
                        continue
                    yi = up2_conv3x3(p.x, kp.permute(2, 3, 1, 0), p.mode, self.pad)
                else:
                    yi = _pad_conv(p, kp, stride, to_pad, self.pad, wgrad)
                y = yi if y is None else y + yi
                off += ci
            if in_shift is not None:
                y = y + (kernel * in_shift.to(kernel.dtype)[None, :, None, None]).sum(
                    (1, 2, 3)).to(y.dtype)
            if self.bias is not None:
                y = y + self.bias.to(y.dtype)
            if self.post_down == "avg":
                y = avg_pool(y, self.stride)
            elif self.post_down == "max":
                y = max_pool(y, self.stride)
            elif self.post_down:
                # the downsample kernel takes f32
                y = downsample(y.to(torch.float32), self.stride, self.post_down, 0.5,
                               True).to(y.dtype)
            return y


class ConvTranspose(nn.Module):
    """Transposed conv, NHWC, with ConvTranspose2d(padding=p)'s semantics
    and its (in, out, k, k) weight; the init's fan-in is in * k * k, as the
    JAX package draws it. Its gradients are cuDNN's."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty(in_channels, features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        w = self.weight
        torch_conv_init_(w, self.bias, generator, w.shape[0] * w.shape[2] * w.shape[3])

    def forward(self, x: torch.Tensor | Rows):
        with span("dip.model.conv"):
            if isinstance(x, Rows):
                return self._rows(x)
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride,
                                   self.padding)
            return y.permute(0, 2, 3, 1)

    def _rows(self, x: Rows) -> Rows:
        """Over row blocks. Output row o sums input rows i with o = i*s - p + t,
        t < K. Block k owns output rows [s*start_k, s*start_{k+1}), the last
        block up to the output's height ((H-1)*s - 2p + K: the 3x3 stride-1
        stem's 2 extra rows go to it). A block gathers the input rows its
        output rows read, zero past the image, runs the transposed conv on
        them unpadded along H, and cuts the rows it owns."""
        s, p, k = self.stride, self.padding, self.weight.shape[2]
        h_out = (x.shape[1] - 1) * s - 2 * p + k
        ends = [s * st for st in x.starts[1:]] + [h_out]
        blocks = []
        for j, blk in enumerate(x.blocks):
            a, b = s * x.starts[j], ends[j]
            lo, hi = -(-(a + p - k + 1) // s), (b - 1 + p) // s + 1
            xr = gather_rows(x, j, lo, hi, "constant")
            dev = xr.device
            y = F.conv_transpose2d(xr.permute(0, 3, 1, 2), self.weight.to(dev),
                                   None if self.bias is None else self.bias.to(dev), s, (0, p))
            cut = a - lo * s + p
            blocks.append(y.permute(0, 2, 3, 1)[:, cut:cut + b - a])
        return Rows(blocks)


class GenNoise(nn.Module):
    """Fresh N(0,1) noise shaped like the NHWC input but with `features`
    channels, drawn from the caller's generator (on the input's device)."""

    def __init__(self, features: int):
        super().__init__()
        self.features = features

    def forward(self, x: torch.Tensor | Rows, generator: torch.Generator):
        """Over row blocks: the whole image's noise, drawn on block 0's device
        as the unsharded op draws it, cut into the blocks' rows."""
        n, h, w, _ = x.shape
        if isinstance(x, Rows):
            noise = torch.randn((n, h, w, self.features), generator=generator,
                                device=x.blocks[0].device, dtype=x.dtype)
            return cut_rows(noise, x.devices, x.heights)
        return torch.randn((n, h, w, self.features), generator=generator, device=x.device,
                           dtype=x.dtype)


def reset_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Torch-style init of every Conv, ConvTranspose and TrainBatchNorm of
    `model`, in registration order, the convs drawing from `generator`."""
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose)):
            m.reset_parameters(generator)
        elif isinstance(m, TrainBatchNorm):
            m.reset_parameters()


def crop_to_min(tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Centre-crop all NHWC inputs to the smallest common H, W (row blocks
    along W only: Rows refuses a crop along H)."""
    with span("dip.model.up"):
        th = min(t.shape[1] for t in tensors)
        tw = min(t.shape[2] for t in tensors)
        out = []
        for t in tensors:
            dh = (t.shape[1] - th) // 2
            dw = (t.shape[2] - tw) // 2
            out.append(t[:, dh:dh + th, dw:dw + tw, :])
        return out


def concat_cropped(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    with span("dip.model.up"):
        return cat_channels(crop_to_min(tensors))
