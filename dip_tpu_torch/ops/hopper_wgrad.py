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

Routing on CUDA tensors:
  bf16  both run the seam weight gradient's mma.sync kernel
        (`csrc/up_conv_wgrad.cu`), which computes the same function on
        NHWC-dense operands: the 3x3 through `dip_wgrad3x3_mma` (split as
        hopper_up_conv.wgrad3x3_plan says), the 1x1 through its one-tap form
        `dip_wgrad1x1_mma` (hopper_up_conv.wgrad_mma_plan, taps 1). A
        channel-planar or otherwise strided x or g is copied once (`_dense`);
        the 3x3's x is padded by one zero pixel for halo=1 (`_k5_operands`),
        the 1x1's channels to a multiple of 8 (`_pad8`: the 3-channel head's
        g would otherwise take the kernel's slow masked staging).
  f32   both run `csrc/wgrad.cu` (`dip_wgrad_f32_fits` with one fit,
        split as `f32_plan` says): register-tiled SIMT FMA over staged
        windows, which takes the inputs' element strides, so nothing is
        copied first.

`Conv3x3S1` and `Conv1x1` are the counterparts of `_conv3x3_s1p1` and
`_conv1x1`: forward F.conv2d (cuDNN), data gradient cuDNN's
convolution_backward (the JAX package keeps dgrad on XLA), weight
gradient the kernel, rounded once to the weight's dtype. Each wrapper takes
its plain version only when every tensor lies on the CPU; on CUDA tensors
it launches the kernel or raises. Each launch adds one to `LAUNCHES`.

The fit axis (parallel/batch.py's BatchEngine, B fits each with its own
weight): both wrappers take `fits` = B, x and g then holding B runs of
N/B images, and give dW (B,k,k,Ci,Co), fit b's summed over its own run
only. One launch serves the B fits in either dtype, with per-fit slabs
and sum pass and a fit's split plan, so a fit's bits are those of its
single-fit launch: in bf16 `dip_wgrad3x3_mma_fits` and
`dip_wgrad1x1_mma_fits` (K3's), in f32 `dip_wgrad_f32_fits` (the fit the
grid's third dimension, x and g read as they lie). Under
torch.func.vmap the Functions' vmap rules fold the fits into N where the
weight is shared, and run `ConvFits` where it is batched: the forward and
the data gradient grouped cuDNN convolutions (groups = B, as BatchEngine's
other convs), the weight gradient the kernel with the fit axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dip_tpu_torch.ops import _build, hopper_up_conv

LAUNCHES = {"wgrad3x3_s1": 0, "wgrad1x1": 0}
_FLOATS = (torch.float32, torch.bfloat16)
# the f32 kernel's tiles (csrc/wgrad.cu): pixel tiles of 64 pixels of one
# image row; a block's output tile of 128 channels x BK columns for each tap
# of one kernel row; one block an SM
_F32_TW, _F32_BC = 64, 128
# waves of blocks its splits aim at (measured on an H100 with
# `seam_times.py --waves`: PERF.md §6)
_F32_WAVES = 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- plain versions -------------------------------------------------------------


def _per_fit(plain, x: torch.Tensor, g: torch.Tensor, fits: int, *args) -> torch.Tensor:
    """A plain version per fit: (fits, k, k, Ci, Co), fit b's from its own
    run of N/fits images."""
    return torch.stack([plain(xb, gb, *args) for xb, gb in zip(x.chunk(fits), g.chunk(fits))])


def wgrad3x3_s1_plain(x: torch.Tensor, g: torch.Tensor, halo: int = 1,
                      fits: int | None = None) -> torch.Tensor:
    """K5's plain version: one f32 einsum per tap over the shifted slices
    (per fit with `fits`)."""
    if fits is not None:
        return _per_fit(wgrad3x3_s1_plain, x, g, fits, halo)
    h, w = _check(x, g, 3, halo)
    xf, gf = x.float(), g.float()
    if halo:
        xf = F.pad(xf, (0, 0, 1, 1, 1, 1))
    dw = torch.stack([torch.einsum("nhwc,nhwk->ck", xf[:, d:d + h, e:e + w], gf)
                      for d in range(3) for e in range(3)])
    return dw.reshape(3, 3, x.shape[3], g.shape[3])


def wgrad1x1_plain(x: torch.Tensor, g: torch.Tensor, fits: int | None = None) -> torch.Tensor:
    """K6's plain version: one f32 einsum over N*H*W (per fit with `fits`)."""
    if fits is not None:
        return _per_fit(wgrad1x1_plain, x, g, fits)
    _check(x, g, 1, 0)
    return torch.einsum("nhwc,nhwk->ck", x.float(), g.float())[None, None]


# -- kernel wrappers ------------------------------------------------------------


def _check(x: torch.Tensor, g: torch.Tensor, ks: int, halo: int,
           fits: int | None = None) -> tuple[int, int]:
    """(H, W) of g; raises outside the kernels' envelope."""
    if fits is not None and (fits < 1 or x.dim() < 1 or x.shape[0] % fits):
        raise ValueError(f"{fits} fits do not divide the images of x {tuple(x.shape)}")
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


class F32Plan(NamedTuple):
    """How the f32 kernel cuts the N*H*W reduction: `splits` slices of
    `tiles_per_split` consecutive 64-pixel row tiles each (the last takes
    the rest), each summed into one slab of an f32 workspace of shape
    `workspace` (splits, ks*ks, Ci, Co rounded up to 4), on a grid of `grid`
    blocks (Ci tiles x column tiles x kernel rows, splits); `block_cols` is
    the column tile (16 for Co <= 16)."""
    tiles: int
    splits: int
    tiles_per_split: int
    block_cols: int
    grid: tuple[int, int]
    workspace: tuple[int, int, int, int]


@functools.lru_cache(maxsize=64)
def f32_plan(n: int, h: int, w: int, ci: int, co: int, ks: int) -> F32Plan:
    """The f32 kernel's split plan for g (N, H, W, Co), Ci input channels
    and a ks x ks kernel (3 or 1), from the shape alone: enough splits for
    _F32_WAVES waves of blocks on the card's SMs (one block an SM), one
    tile a split at the least. No floor of tiles a split: the small 'kate'
    shapes (R = 16-128) have too few tiles to fill a wave as it is."""
    if ks not in (3, 1):
        raise ValueError(f"ks must be 3 or 1, got {ks}")
    bk = 16 if co <= 16 else (64 if ks == 3 else 128)
    tiles = n * h * -(-w // _F32_TW)
    blocks = -(-ci // _F32_BC) * -(-co // bk) * (3 if ks == 3 else 1)
    splits = min(-(-_F32_WAVES * hopper_up_conv._SMS // blocks), tiles)
    per = -(-tiles // splits)
    splits = -(-tiles // per)
    return F32Plan(tiles, splits, per, bk, (blocks, splits),
                   (splits, ks * ks, ci, -(-co // 4) * 4))


def _launch_f32(x: torch.Tensor, g: torch.Tensor, ks: int, halo: int,
                fits: int | None = None) -> torch.Tensor:
    """The f32 kernel on x and g as they lie (their strides are passed),
    through the fit-axis entry: with `fits`, one launch for the fits, each
    split as one fit's images are; without, one fit of all the images."""
    n, h, w, co = g.shape
    ci = x.shape[3]
    b = 1 if fits is None else fits
    plan = f32_plan(n // b, h, w, ci, co, ks)
    ws = torch.empty((b, *plan.workspace), dtype=torch.float32, device=x.device)
    dw = torch.empty((b, ks, ks, ci, co), dtype=torch.float32, device=x.device)
    rc = _build.load().dip_wgrad_f32_fits(
        x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(), b, n, h, w, x.shape[1],
        x.shape[2], ci, co, *x.stride(), *g.stride(), ks, halo, plan.splits,
        plan.tiles_per_split, plan.workspace[3], _build.stream())
    _build.raise_on(rc, f"wgrad {ks}x{ks} f32")
    return dw if fits is not None else dw[0]


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


def _pad8(t: torch.Tensor) -> torch.Tensor:
    """The 1x1 kernel's operand: t NHWC-dense and 16-byte aligned, its
    channels zero-padded to a multiple of 8 where they are not one (so the
    kernel's 16-byte copies apply), one copy at most."""
    c = t.shape[3]
    if c % 8 == 0:
        return _dense(t)
    out = t.new_zeros((*t.shape[:3], -(-c // 8) * 8))
    out[..., :c] = t
    return out


def _launch_mma(x: torch.Tensor, g: torch.Tensor, ks: int, halo: int,
                fits: int | None = None) -> torch.Tensor:
    """The bf16 mma.sync kernel (3x3 or its one-tap 1x1 form) on NHWC-dense
    operands, each copied once at most; the 1x1's zero-padded channels add
    zero rows and columns to dW, which are cut off. With `fits`, one launch
    through the fit-axis entry, each fit split as one fit's images are."""
    xd, gd = _k5_operands(x, g, halo) if ks == 3 else (_pad8(x), _pad8(g))
    n, h, w, co = gd.shape
    ci = xd.shape[3]
    b = 1 if fits is None else fits
    plan = hopper_up_conv.wgrad_mma_plan(n // b, h, w, ci, co, ks * ks)
    lead = () if fits is None else (fits,)
    ws = torch.empty((*lead, *plan.workspace), dtype=torch.float32, device=x.device)
    dw = torch.empty((*lead, ks, ks, ci, co), dtype=torch.float32, device=x.device)
    lib = _build.load()
    args = (n, h, w, ci, co, plan.splits, plan.tiles_per_split, 1, _build.stream())
    if fits is None:
        entry = lib.dip_wgrad3x3_mma if ks == 3 else lib.dip_wgrad1x1_mma
    else:
        entry = lib.dip_wgrad3x3_mma_fits if ks == 3 else lib.dip_wgrad1x1_mma_fits
        args = (fits, *args)
    rc = entry(xd.data_ptr(), gd.data_ptr(), ws.data_ptr(), dw.data_ptr(), *args)
    _build.raise_on(rc, f"wgrad {ks}x{ks} bf16")
    return dw[..., :x.shape[3], :g.shape[3]]


def _launch(x: torch.Tensor, g: torch.Tensor, ks: int, halo: int, fits: int | None,
            name: str) -> torch.Tensor:
    """The kernel for x's dtype, one launch (for all the fits with `fits`)
    counted under `name`."""
    launch = _launch_mma if x.dtype == torch.bfloat16 else _launch_f32
    dw = launch(x, g, ks, halo, fits)
    LAUNCHES[name] += 1
    return dw


def wgrad3x3_s1(x: torch.Tensor, g: torch.Tensor, halo: int = 1,
                fits: int | None = None) -> torch.Tensor:
    """dW (3,3,Ci,Co) f32 of a stride-1 3x3 conv (see the module docstring);
    with `fits`, (fits,3,3,Ci,Co), fit b's from its own run of images."""
    _check(x, g, 3, halo, fits)
    if _build.on_cpu(x=x, g=g):
        return wgrad3x3_s1_plain(x, g, halo, fits)
    return _launch(x, g, 3, halo, fits, "wgrad3x3_s1")


def wgrad1x1(x: torch.Tensor, g: torch.Tensor, fits: int | None = None) -> torch.Tensor:
    """dW (1,1,Ci,Co) f32 of a 1x1 conv; with `fits`, (fits,1,1,Ci,Co)."""
    _check(x, g, 1, 0, fits)
    if _build.on_cpu(x=x, g=g):
        return wgrad1x1_plain(x, g, fits)
    return _launch(x, g, 1, 0, fits, "wgrad1x1")


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


def _vmap_conv(info, in_dims, x: torch.Tensor, weight: torch.Tensor,
               halo: int, shared) -> tuple[torch.Tensor, int]:
    """The vmap rule of Conv3x3S1 (halo 0 or 1) and Conv1x1 (halo None):
    with a shared weight the fits fold into N (`shared`, the Function
    itself); with a batched weight ConvFits runs the B fits."""
    b = info.batch_size
    x_dim, w_dim = in_dims[0], in_dims[1]
    x = hopper_up_conv._batch_first(x, x_dim, b)
    folded = x.reshape(-1, *x.shape[2:])
    if w_dim is None:
        out = shared(folded, weight) if halo is None else shared(folded, weight, halo)
    else:
        out = ConvFits.apply(folded, weight.movedim(w_dim, 0), 1 if halo is None else halo)
    return out.reshape(b, x.shape[1], *out.shape[1:]), 0


class Conv3x3S1(torch.autograd.Function):
    """Stride-1 3x3 conv, NHWC x and OIHW weight: halo=1 pads x with zeros
    (padding 1), halo=0 takes x padded already (VALID). Backward: cuDNN's
    data gradient, K5's weight gradient. Under torch.func.vmap, see
    `_vmap_conv`."""

    @staticmethod
    def forward(x: torch.Tensor, weight: torch.Tensor, halo: int) -> torch.Tensor:
        return _conv(x, weight, halo)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        x, weight, halo = inputs
        ctx.save_for_backward(x, weight)
        ctx.halo = halo

    @staticmethod
    def vmap(info, in_dims, x, weight, halo):
        return _vmap_conv(info, in_dims, x, weight, halo, conv3x3_s1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight = ctx.saved_tensors
        dw = _to_oihw(wgrad3x3_s1(x, g, ctx.halo), weight) if ctx.needs_input_grad[1] else None
        return _dgrad(ctx, g, x, weight, ctx.halo), dw, None


class Conv1x1(torch.autograd.Function):
    """1x1 conv, NHWC x and OIHW weight. Backward: cuDNN's data gradient,
    K6's weight gradient. Under torch.func.vmap, see `_vmap_conv`."""

    @staticmethod
    def forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return _conv(x, weight, 0)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.save_for_backward(*inputs)

    @staticmethod
    def vmap(info, in_dims, x, weight):
        return _vmap_conv(info, in_dims, x, weight, None, conv1x1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight = ctx.saved_tensors
        dw = _to_oihw(wgrad1x1(x, g), weight) if ctx.needs_input_grad[1] else None
        return _dgrad(ctx, g, x, weight, 0), dw


def _grouped(t: torch.Tensor, fits: int) -> torch.Tensor:
    """(B*N, H, W, K) fit-major -> (N, H, W, B*K), fit b's channels at
    [b*K, (b+1)*K): a grouped convolution's layout."""
    bn, h, w, k = t.shape
    return t.reshape(fits, bn // fits, h, w, k).permute(1, 2, 3, 0, 4).reshape(
        bn // fits, h, w, fits * k)


def _ungrouped(t: torch.Tensor, fits: int) -> torch.Tensor:
    """_grouped's inverse: (N, H, W, B*K) -> (B*N, H, W, K)."""
    n, h, w, bk = t.shape
    return t.reshape(n, h, w, fits, bk // fits).permute(3, 0, 1, 2, 4).reshape(
        fits * n, h, w, bk // fits)


class ConvFits(torch.autograd.Function):
    """B fits' stride-1 convs at once, each fit its own weight: x (B*N,
    Hx, Wx, Ci) fit-major, weight (B, Co, Ci, k, k), halo as Conv3x3S1's
    (1 pads with zeros, 0 takes x padded; a 1x1 conv passes 1 and pads
    nothing) -> (B*N, H, W, Co). Forward and data gradient: one grouped
    cuDNN convolution each (groups = B); weight gradient: K5 or K6 with the
    fit axis (one launch for the B fits)."""

    @staticmethod
    def forward(x: torch.Tensor, weight: torch.Tensor, halo: int) -> torch.Tensor:
        fits, ks = weight.shape[0], weight.shape[-1]
        pad = halo if ks == 3 else 0
        y = F.conv2d(_grouped(x, fits).permute(0, 3, 1, 2), weight.reshape(-1, *weight.shape[2:]),
                     None, 1, pad, 1, fits)
        return _ungrouped(y.permute(0, 2, 3, 1), fits)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        x, weight, halo = inputs
        ctx.save_for_backward(x, weight)
        ctx.halo = halo

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, weight = ctx.saved_tensors
        fits, ks = weight.shape[0], weight.shape[-1]
        pad = ctx.halo if ks == 3 else 0
        dx = dw = None
        if ctx.needs_input_grad[0]:
            w2 = weight.reshape(-1, *weight.shape[2:])
            dx = torch.ops.aten.convolution_backward(
                _grouped(g, fits).permute(0, 3, 1, 2), _grouped(x, fits).permute(0, 3, 1, 2),
                w2, None, (1, 1), (pad, pad), (1, 1), False, (0, 0), fits,
                (True, False, False))[0]
            dx = _ungrouped(dx.permute(0, 2, 3, 1), fits)
        if ctx.needs_input_grad[1]:
            dwf = (wgrad3x3_s1(x, g, ctx.halo, fits) if ks == 3 else wgrad1x1(x, g, fits))
            dw = dwf.permute(0, 4, 3, 1, 2).to(weight.dtype)
        return dx, dw, None


def conv3x3_s1(x: torch.Tensor, weight: torch.Tensor, halo: int) -> torch.Tensor:
    return Conv3x3S1.apply(x, weight, halo)


def conv1x1(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return Conv1x1.apply(x, weight)
