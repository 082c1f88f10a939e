"""Plain reference of Deep Image Prior's skip generator (the encoder-decoder
with per-scale skips of the deep-image-prior repository's models/skip.py),
NCHW inside, NHWC at the edges as the benchmark's inputs are:

  down pass, scale i:  skip_i = act(bn(conv_1x1(x_i)))
                       x_{i+1} = act(bn(conv(act(bn(conv_stride2(x_i))))))
  up pass, scale i:    u = bn(concat(skip_i, upsample_2x(u)))
                       u = act(bn(conv_k(u)))
                       u = act(bn(conv_1x1(u)))
  head:                sigmoid(conv_1x1(u))

Every conv pads its input by (k - 1) // 2 on each side as the config's
`pad` says and has a bias; BatchNorm normalises by the batch's own
statistics (biased variance, eps 1e-5) and keeps no running averages;
`act` is LeakyReLU(0.2). Parameters are named `convs.{i}.weight|bias`
(OIHW) and `bns.{j}.weight|bias` in the order the layers are made, the
names the benchmark hands the same weights to the program by.

Precision. Every operation is float32 with TF32 off. `operands` rounds
every conv's operands below it, its sums still f32: 'fp8' per-tensor
scaled (e4m3 forward, e5m2 cotangents), the control of a bf16
configuration; 'bf16', a look at what the configuration's own rounding
does to each number the check compares.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

_PADS = {"reflection": "reflect", "replication": "replicate", "zero": "constant"}
_SEAM_PADS = ("reflection", "replication")
_SEAM_MODES = ("bilinear", "nearest")
BN_EPS = 1e-5


class ConvSpec(NamedTuple):
    """One conv of the net: `parts` are its input channels as (count, kind),
    kind 'conv' or 'seam' (the up part of a decoder seam); `reads_input` is
    true where its input is the net's input z, which needs no gradient."""
    name: str
    parts: tuple[tuple[int, str], ...]
    cout: int
    k: int
    stride: int
    h_out: int
    w_out: int
    reads_input: bool


def _per_scale(value, n: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


def is_seam(net: dict, i: int, h_lr: int, w_lr: int) -> bool:
    """Whether decoder level i (LR input h_lr x w_lr) is a fused seam: a 2x
    bilinear or nearest upsample into a stride-1 3x3 conv with edge-like
    padding, the LR input at least 2 x 2 (the rule of the program's seam,
    dip_tpu_torch/ops/up_conv.py's can_fuse_up2, frozen here)."""
    n = len(net["num_channels_down"])
    return (_per_scale(net["upsample_mode"], n)[i] in _SEAM_MODES
            and _per_scale(net["filter_size_up"], n)[i] == 3
            and net["pad"] in _SEAM_PADS and h_lr >= 2 and w_lr >= 2)


def convs(net: dict, h: int, w: int) -> list[ConvSpec]:
    """Every conv of the net at an h x w input, in the order they are made."""
    n = len(net["num_channels_down"])
    down, up, skip = net["num_channels_down"], net["num_channels_up"], net["num_channels_skip"]
    kd, ku = _per_scale(net["filter_size_down"], n), _per_scale(net["filter_size_up"], n)
    ksk = net["filter_skip_size"]
    out: list[ConvSpec] = []

    def add(parts, cout, k, stride, hh, ww, reads_input=False):
        p = (k - 1) // 2
        ho, wo = (hh + 2 * p - k) // stride + 1, (ww + 2 * p - k) // stride + 1
        out.append(ConvSpec(f"convs.{len(out)}", tuple(parts), cout, k, stride, ho, wo,
                            reads_input))
        return ho, wo

    sizes, cin, hh, ww = [], net["num_input_channels"], h, w
    for i in range(n):
        sizes.append((hh, ww))
        if skip[i]:
            add([(cin, "conv")], skip[i], ksk, 1, hh, ww, i == 0)
        hh, ww = add([(cin, "conv")], down[i], kd[i], 2, hh, ww, i == 0)
        add([(down[i], "conv")], down[i], kd[i], 1, hh, ww)
        cin = down[i]
    for i in reversed(range(n)):
        hs, ws = sizes[i]
        if (2 * hh, 2 * ww) != (hs, ws):
            raise ValueError(f"the reference needs sizes that halve evenly, got {h}x{w}")
        kind = "seam" if is_seam(net, i, hh, ww) else "conv"
        parts = ([(skip[i], "conv")] if skip[i] else []) + [(cin, kind)]
        hh, ww = add(parts, up[i], ku[i], 1, hs, ws)
        if net["need1x1_up"]:
            add([(up[i], "conv")], up[i], 1, 1, hh, ww)
        cin = up[i]
    add([(cin, "conv")], net["num_output_channels"], 1, 1, hh, ww)
    return out


class Param(NamedTuple):
    """A parameter: its name, shape and initial value, U(-bound, bound) where
    `bound` > 0 (PyTorch's conv default, bound 1/sqrt(fan_in) for the weight
    and the bias), else the constant `fill` (BatchNorm's 1 and 0)."""
    name: str
    shape: tuple[int, ...]
    bound: float
    fill: float = 0.0


def param_list(net: dict, h: int, w: int) -> list[Param]:
    """Every parameter, in the order the program makes them."""
    n = len(net["num_channels_down"])
    specs = iter(convs(net, h, w))
    out: list[Param] = []
    bns = 0

    def conv():
        s = next(specs)
        cin = sum(c for c, _ in s.parts)
        bound = 1.0 / math.sqrt(cin * s.k * s.k)
        out.append(Param(f"{s.name}.weight", (s.cout, cin, s.k, s.k), bound))
        out.append(Param(f"{s.name}.bias", (s.cout,), bound))
        return s.cout

    def bn(features):
        nonlocal bns
        out.append(Param(f"bns.{bns}.weight", (features,), 0.0, 1.0))
        out.append(Param(f"bns.{bns}.bias", (features,), 0.0, 0.0))
        bns += 1

    skip, down = net["num_channels_skip"], net["num_channels_down"]
    for i in range(n):
        if skip[i]:
            bn(conv())
        bn(conv())
        bn(conv())
    cin = down[-1]
    for i in reversed(range(n)):
        bn(skip[i] + cin)
        bn(conv())
        if net["need1x1_up"]:
            bn(conv())
        cin = net["num_channels_up"][i]
    conv()
    return out


# -- operands rounded below f32 (a control, or a look) ------------------------------

def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to fp8 `dtype` under a per-tensor scale (amax to the
    format's largest value), back in f32."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


# operands -> (rounding of the forward operands, rounding of the cotangent)
ROUNDINGS = {"fp8": (lambda x: _fp8(x, torch.float8_e4m3fn), lambda g: _fp8(g, torch.float8_e5m2)),
             "bf16": (_bf16, _bf16)}


class _RoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, operands):
        fwd, ctx.bwd = ROUNDINGS[operands]
        xq, wq = fwd(x), fwd(w)
        ctx.save_for_backward(xq, wq)
        ctx.stride = stride
        return F.conv2d(xq, wq, None, stride)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.bwd(g)
        dx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, ctx.stride)
        dw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, ctx.stride)
        return dx, dw, None, None


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, operands: str | None) -> torch.Tensor:
    """VALID conv of an already padded NCHW x with OIHW w."""
    if operands:
        return _RoundedConv.apply(x, w, stride, operands)
    return F.conv2d(x, w, None, stride)


# -- the net ----------------------------------------------------------------------

def forward(params: dict[str, torch.Tensor], net: dict, z: torch.Tensor,
            operands: str | None = None) -> torch.Tensor:
    """The skip net on NHWC z (N, H, W, Cin) -> NHWC (N, H, W, Cout), f32;
    `operands` 'fp8' or 'bf16' rounds every conv's operands (ROUNDINGS)."""
    n = len(net["num_channels_down"])
    pad, act_slope = _PADS[net["pad"]], 0.2
    if net["act_fun"] != "LeakyReLU":
        raise NotImplementedError(f"act_fun {net['act_fun']!r}")
    up_modes = _per_scale(net["upsample_mode"], n)
    specs = iter(convs(net, z.shape[1], z.shape[2]))
    bn_index = itertools.count()

    def conv(x, s: ConvSpec):
        p = (s.k - 1) // 2
        xp = F.pad(x, (p, p, p, p), mode=pad) if p else x
        y = _conv(xp, params[f"{s.name}.weight"], s.stride, operands)
        return y + params[f"{s.name}.bias"].view(1, -1, 1, 1)

    def bn(x):
        j = next(bn_index)
        return F.batch_norm(x, None, None, params[f"bns.{j}.weight"], params[f"bns.{j}.bias"],
                            training=True, eps=BN_EPS)

    def cba(x):
        return F.leaky_relu(bn(conv(x, next(specs))), act_slope)

    x = z.permute(0, 3, 1, 2)
    skips = []
    for i in range(n):
        skips.append(cba(x) if net["num_channels_skip"][i] else None)
        x = cba(cba(x))
    u = x
    for i in reversed(range(n)):
        sk, mode = skips[i], up_modes[i]
        up = F.interpolate(u, scale_factor=2, mode=mode,
                           **({"align_corners": False} if mode == "bilinear" else {}))
        y = conv(bn(torch.cat([sk, up], 1) if sk is not None else up), next(specs))
        u = F.leaky_relu(bn(y), act_slope)
        if net["need1x1_up"]:
            u = cba(u)
    out = torch.sigmoid(conv(u, next(specs))) if net["need_sigmoid"] else conv(u, next(specs))
    return out.permute(0, 2, 3, 1)

