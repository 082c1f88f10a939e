"""Convolution weight gradients (K5, K6): their Hopper kernels, plain
versions, and the autograd.Functions that use them.

Counterpart of dip_tpu/ops/pallas_wgrad.py:

  wgrad3x3_s1  x (N,Hx,Wx,Ci), g (N,H,W,Co) -> dW (3,3,Ci,Co) f32 of a
               stride-1 3x3 conv; halo=1: x unpadded (Hx = H), zero outside
               it; halo=0: x carries the conv's 1-pixel pad (Hx = H + 2)
  wgrad1x1     x (N,H,W,Ci), g (N,H,W,Co)  -> dW (1,1,Ci,Co) f32

N is summed. The kernels stand in for cuDNN's weight gradient: bf16
inputs run bf16 tensor-core products with f32 sums, f32 inputs true f32
(no TF32). The plain versions compute in f32 from the same inputs, so
kernel and plain version differ only in the order of the f32 sums.

In bf16, wgrad3x3_s1 runs the seam weight gradient's mma.sync kernel
(`csrc/up_conv_wgrad.cu`, split as hopper_up_conv.wgrad3x3_plan says),
which computes the same function on a padded x with Co columns. It takes
NHWC-dense operands, so `_k5_operands` copies a channel-planar or
otherwise strided x or g once, and pads x by one zero pixel for halo=1.
In f32, and wgrad1x1 in both dtypes, run `csrc/wgrad.cu`, whose kernels
take the inputs' strides, so neither input is copied first.

`Conv3x3S1` and `Conv1x1` are the counterparts of `_conv3x3_s1p1` and
`_conv1x1`: forward F.conv2d (cuDNN), data gradient cuDNN's
convolution_backward (the JAX package keeps dgrad on XLA), weight
gradient the kernel, rounded once to the weight's dtype. Each wrapper takes
its plain version only when every tensor lies on the CPU; on CUDA tensors
it launches the kernel or raises. Each launch adds one to `LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dip_tpu_torch.ops import _build, hopper_up_conv

LAUNCHES = {"wgrad3x3_s1": 0, "wgrad1x1": 0}
_FLOATS = (torch.float32, torch.bfloat16)
TARGET_BLOCKS = 512   # about four blocks per SM of an H100 across the splits
MIN_SPLIT_PIXELS = 1024


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain versions -------------------------------------------------------------


def wgrad3x3_s1_plain(x: torch.Tensor, g: torch.Tensor, halo: int = 1) -> torch.Tensor:
    """K5's plain version: one f32 einsum per tap over the shifted slices."""
    h, w = _check(x, g, 3, halo)
    xf, gf = x.float(), g.float()
    if halo:
        xf = F.pad(xf, (0, 0, 1, 1, 1, 1))
    dw = torch.stack([torch.einsum("nhwc,nhwk->ck", xf[:, d:d + h, e:e + w], gf)
                      for d in range(3) for e in range(3)])
    return dw.reshape(3, 3, x.shape[3], g.shape[3])


def wgrad1x1_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K6's plain version: one f32 einsum over N*H*W."""
    _check(x, g, 1, 0)
    return torch.einsum("nhwc,nhwk->ck", x.float(), g.float())[None, None]


# -- kernel wrappers ------------------------------------------------------------


def _check(x: torch.Tensor, g: torch.Tensor, ks: int, halo: int) -> tuple[int, int]:
    """(H, W) of g; raises outside the kernels' envelope."""
    if halo not in (0, 1) or (ks == 1 and halo):
        raise ValueError(f"halo {halo} is not one of the kernel's ({ks}x{ks})")
    if x.dim() != 4 or g.dim() != 4 or x.shape[0] != g.shape[0]:
        raise ValueError(f"x (N,Hx,Wx,Ci) and g (N,H,W,Co) expected, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    n, h, w = g.shape[:3]
    grow = (ks - 1) - 2 * halo  # how much larger than g x is
    if tuple(x.shape[1:3]) != (h + grow, w + grow) or min(n, h, w, x.shape[3], g.shape[3]) < 1:
        raise ValueError(f"a {ks}x{ks} conv with halo {halo} does not map x "
                         f"{tuple(x.shape)} onto g {tuple(g.shape)}")
    if x.dtype not in _FLOATS or g.dtype != x.dtype:
        raise TypeError(f"x and g must share float32 or bfloat16, got {x.dtype} and {g.dtype}")
    return h, w


def _splits(pixels: int, blocks_per_split: int, stage: int) -> tuple[int, int]:
    """(splits, pixels per split) of the N*H*W reduction: enough blocks to
    fill the card, each split at least MIN_SPLIT_PIXELS long (or one
    split), a whole number of stages."""
    splits = max(1, min(-(-TARGET_BLOCKS // blocks_per_split), pixels // MIN_SPLIT_PIXELS,
                        65535))
    per = -(-pixels // splits)
    per = -(-per // stage) * stage
    return -(-pixels // per), per


def _launch(x: torch.Tensor, g: torch.Tensor, ks: int, halo: int) -> torch.Tensor:
    lib = _build.load()
    n, h, w, co = g.shape
    ci = x.shape[3]
    is_f32 = int(x.dtype == torch.float32)
    tc, tk, tp = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.dip_wgrad_tiles(is_f32, co, ctypes.byref(tc), ctypes.byref(tk), ctypes.byref(tp))
    ci_pad = -(-ci // tc.value) * tc.value
    co_pad = -(-co // tk.value) * tk.value
    splits, per = _splits(n * h * w, (ci_pad // tc.value) * (co_pad // tk.value) * ks * ks,
                          tp.value)
    ws = torch.empty((splits, ks * ks, ci_pad, co_pad), dtype=torch.float32, device=x.device)
    dw = torch.empty((ks, ks, ci, co), dtype=torch.float32, device=x.device)
    rc = lib.dip_wgrad(x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(), n, h, w,
                       x.shape[1], x.shape[2], ci, co, *x.stride(), *g.stride(), ks, halo,
                       splits, per, is_f32, _build.stream())
    _build.raise_on(rc, f"wgrad {ks}x{ks}")
    return dw


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t itself if it is NHWC-dense at a 16-byte aligned address, else one
    dense copy of it."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _k5_operands(x: torch.Tensor, g: torch.Tensor, halo: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The operands of the bf16 3x3 kernel: x (N,H+2,W+2,Ci) with its pixel
    of padding (halo=1: one zero pixel added here) and g (N,H,W,Co), both
    NHWC-dense and 16-byte aligned, each one copy at most."""
    if halo:
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
    return _dense(x), _dense(g)


def _launch3x3_bf16(x: torch.Tensor, g: torch.Tensor, halo: int) -> torch.Tensor:
    xd, gd = _k5_operands(x, g, halo)
    n, h, w, co = g.shape
    ci = x.shape[3]
    plan = hopper_up_conv.wgrad3x3_plan(n, h, w, ci, co)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, ci, co), dtype=torch.float32, device=x.device)
    rc = _build.load().dip_wgrad3x3_mma(
        xd.data_ptr(), gd.data_ptr(), ws.data_ptr(), dw.data_ptr(), n, h, w, ci, co,
        plan.splits, plan.tiles_per_split, 1, _build.stream())
    _build.raise_on(rc, "wgrad 3x3 bf16")
    return dw


def wgrad3x3_s1(x: torch.Tensor, g: torch.Tensor, halo: int = 1) -> torch.Tensor:
    """dW (3,3,Ci,Co) f32 of a stride-1 3x3 conv (see the module docstring)."""
    _check(x, g, 3, halo)
    if _build.on_cpu(x=x, g=g):
        return wgrad3x3_s1_plain(x, g, halo)
    dw = _launch3x3_bf16(x, g, halo) if x.dtype == torch.bfloat16 else _launch(x, g, 3, halo)
    LAUNCHES["wgrad3x3_s1"] += 1
    return dw


def wgrad1x1(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW (1,1,Ci,Co) f32 of a 1x1 conv."""
    _check(x, g, 1, 0)
    if _build.on_cpu(x=x, g=g):
        return wgrad1x1_plain(x, g)
    dw = _launch(x, g, 1, 0)
    LAUNCHES["wgrad1x1"] += 1
    return dw


# -- autograd -------------------------------------------------------------------


def _conv(x: torch.Tensor, weight: torch.Tensor, padding: int) -> torch.Tensor:
    """NHWC x, OIHW weight, stride 1, no bias -> NHWC."""
    return F.conv2d(x.permute(0, 3, 1, 2), weight, None, 1, padding).permute(0, 2, 3, 1)


def _dgrad(ctx, g: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
           padding: int) -> torch.Tensor | None:
    """The conv's data gradient by cuDNN, given the real input so that its
    memory format (channels_last) picks the algorithm; None if x needs none."""
    if not ctx.needs_input_grad[0]:
        return None
    dx = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None, (1, 1),
        (padding, padding), (1, 1), False, (0, 0), 1, (True, False, False))[0]
    return dx.permute(0, 2, 3, 1)


def _to_oihw(dw: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return dw.permute(3, 2, 0, 1).to(weight.dtype)


class Conv3x3S1(torch.autograd.Function):
    """Stride-1 3x3 conv, NHWC x and OIHW weight: halo=1 pads x with zeros
    (padding 1), halo=0 takes x padded already (VALID). Backward: cuDNN's
    data gradient, K5's weight gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor, halo: int) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        ctx.halo = halo
        return _conv(x, weight, halo)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight = ctx.saved_tensors
        dw = _to_oihw(wgrad3x3_s1(x, g, ctx.halo), weight) if ctx.needs_input_grad[1] else None
        return _dgrad(ctx, g, x, weight, ctx.halo), dw, None


class Conv1x1(torch.autograd.Function):
    """1x1 conv, NHWC x and OIHW weight. Backward: cuDNN's data gradient,
    K6's weight gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, weight)
        return _conv(x, weight, 0)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight = ctx.saved_tensors
        dw = _to_oihw(wgrad1x1(x, g), weight) if ctx.needs_input_grad[1] else None
        return _dgrad(ctx, g, x, weight, 0), dw


def conv3x3_s1(x: torch.Tensor, weight: torch.Tensor, halo: int) -> torch.Tensor:
    return Conv3x3S1.apply(x, weight, halo)


def conv1x1(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return Conv1x1.apply(x, weight)
