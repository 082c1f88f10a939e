"""The exact moments of a virtual bilinear 2x upsample as Hopper kernels:
the forward, the backward, the PyTorch formula (the CPU's form), the
backward kernel's plain version, and the autograd.Function that joins them.

BatchNorm over a fused decoder seam's upsampled part needs the mean and
variance of up2(x) over (N, H, W). ops/up_conv.py's up2_moments computes
them on the LR tensor x (N, h, w, C): with M = N h w and G = U^T U, the
tridiagonal Gram matrix of the clamped bilinear up2 matrix U,

    mean = sum x / M,  second = x . ((G_h (x) G_w) x) / 4M,
    var  = max(second - mean^2, 0),

products and sums in f32, mean and var returned in x's dtype. The kernels
(`csrc/up2_moments.cu`) compute the same in one read of x forward (a
partial-sums pass and a tiny fixed-order finish pass, so the bits repeat)
and one stencil pass backward (read x, write dx), keeping only x and the f32
(mean, second) for the backward:

    dx = (g_mean - 2 mean g_s) / M + g_s 2 ((G_h (x) G_w) x) / 4M,

g_s = g_var where second - mean^2 >= 0 (torch.clamp's mask), else 0.

The fit axis (parallel/batch.py's BatchEngine): the wrappers take x as
(B, N, h, w, C), B fits of N images, and give per-fit (B, C) moments in one
launch; a fit's grid and sums are its own, so its bits do not depend on B.
Under torch.func.vmap, Up2Moments' vmap rule runs the fits form on the
physical tensor.

`moments` and `moments_bwd` launch the kernels on CUDA tensors and raise on
any other input: the CPU takes up2_moments_plain (ops/up_conv.py sends it
there), and moments_bwd_plain is the backward kernel's reference. Each
launch adds one to `LAUNCHES` (`moments_fwd`: the forward's two kernels;
`moments_bwd`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dip_tpu_torch.ops import _build
from dip_tpu_torch.ops.consts import device_const as _const

LAUNCHES = {"moments_fwd": 0, "moments_bwd": 0}
_FLOATS = (torch.float32, torch.bfloat16)
_F32 = torch.float32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _gram_diag(L: int) -> np.ndarray:
    """The diagonal of U^T U for the (2L, L) bilinear up2 matrix U."""
    g = np.full(L, 1.25, np.float32)
    g[0] = g[-1] = 1.625
    return g


# -- plain versions -------------------------------------------------------------


def _sums_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 (mean, second) of up2(x) for x (N, h, w, C), in PyTorch ops."""
    n, h, w, c = x.shape
    xf = x.to(_F32)
    mean = xf.mean((0, 1, 2))
    g0h = _const(_gram_diag, h, _F32, x.device)
    g0w = _const(_gram_diag, w, _F32, x.device)
    s0 = torch.einsum("nhwc,h,w->c", xf * xf, g0h, g0w)
    sh = 0.75 * torch.einsum("nhwc,w->c", xf[:, :-1] * xf[:, 1:], g0w)
    sw = 0.75 * torch.einsum("nhwc,h->c", xf[:, :, :-1] * xf[:, :, 1:], g0h)
    sd = 0.28125 * ((xf[:, :-1, :-1] * xf[:, 1:, 1:]).sum((0, 1, 2))
                    + (xf[:, 1:, :-1] * xf[:, :-1, 1:]).sum((0, 1, 2)))
    return mean, (s0 + sh + sw + sd) / (n * 4 * h * w)


def up2_moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) of up2(x), x (N, h, w, C), in x's dtype: PyTorch ops,
    differentiable by autograd."""
    mean, second = _sums_plain(x)
    var = torch.clamp(second - mean * mean, min=0.0)
    return mean.to(x.dtype), var.to(x.dtype)


def _gram_apply(x: torch.Tensor) -> torch.Tensor:
    """(G_h (x) G_w) x over the (h, w) axes of x (..., h, w, C), f32: the
    3x3 stencil, neighbours outside the image zero."""
    h, w = x.shape[-3], x.shape[-2]
    g0h = _const(_gram_diag, h, _F32, x.device)[:, None, None]
    g0w = _const(_gram_diag, w, _F32, x.device)[:, None]
    xw = F.pad(x, (0, 0, 1, 1))
    r = g0w * x + 0.375 * (xw[..., :-2, :] + xw[..., 2:, :])
    rh = F.pad(r, (0, 0, 0, 0, 1, 1))
    return g0h * r + 0.375 * (rh[..., :-2, :, :] + rh[..., 2:, :, :])


def moments_bwd_plain(x: torch.Tensor, stats: torch.Tensor, g_mean: torch.Tensor,
                      g_var: torch.Tensor) -> torch.Tensor:
    """The backward kernel's plain version: x (..., N, h, w, C), stats
    (..., 2, C), g_mean and g_var (..., C) -> dx in x's dtype."""
    n, h, w, c = x.shape[-4:]
    m = n * h * w
    mean, second = stats[..., 0, :], stats[..., 1, :]
    gs = torch.where(second - mean * mean >= 0, g_var.to(_F32), 0.0)
    a = (g_mean.to(_F32) - 2.0 * mean * gs) / m
    b = gs / (2.0 * m)
    view = (*x.shape[:-4], 1, 1, 1, c)
    return (a.view(view) + b.view(view) * _gram_apply(x.to(_F32))).to(x.dtype)


# -- kernel wrappers ------------------------------------------------------------

_THREADS = 256  # a block's units (csrc/up2_moments.cu's kThreads)
_SMS = 132  # the H100 SXM's streaming multiprocessors


@functools.lru_cache(maxsize=64)
def plan(n: int, h: int, w: int, c: int, vec: bool) -> tuple[int, int]:
    """(rows a tile, blocks a fit) of both kernels' grid for one fit's x
    (N, h, w, C): a block owns 256 units of a row (8 values of its fastest
    axis a unit with `vec`, else 1) over a tile of rows; tiles of 16 rows,
    halved down to 4 while a fit has fewer than two blocks an SM. The
    blocks a fit are the forward's partial rows."""
    unit_tiles = -(-w * c // (8 if vec else 1) // _THREADS)
    rows = 16
    while rows > 4 and n * -(-h // rows) * unit_tiles < 2 * _SMS:
        rows //= 2
    return rows, n * -(-h // rows) * unit_tiles


def _dims(x: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(fits, N, h, w, C) of x (N, h, w, C), one fit, or (B, N, h, w, C)."""
    if x.dim() not in (4, 5) or x.shape[-3] < 2 or x.shape[-2] < 2 or 0 in x.shape:
        raise ValueError(f"x (N, h, w, C) or (B, N, h, w, C) with h, w >= 2 expected, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _FLOATS:
        raise TypeError(f"up2 moments take float32 or bfloat16, got {x.dtype}")
    return (1 if x.dim() == 4 else x.shape[0], *x.shape[-4:])


def _on_card(**tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    if _build.on_cpu(**tensors):
        raise ValueError("the up2 moments' kernels take CUDA tensors; on the CPU "
                         "up2_moments_plain computes the moments")


def _layout(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """x as the kernels read it, and whether its channels are its fastest
    axis: NHWC-contiguous, or the channel-planar NHWC view of an NCHW
    tensor (what a cuDNN conv's output permuted to NHWC can be), as it is;
    any other layout copied to NHWC."""
    if x.is_contiguous():
        return x, True
    if x.movedim(-1, -3).is_contiguous():
        return x, False
    return x.contiguous(), True


def _args(x: torch.Tensor, cfast: bool, *more: torch.Tensor) -> tuple[int, ...]:
    """x's five element strides (fit, image, row, column, channel) and
    whether a thread takes 8 values of the fastest axis: that axis a
    multiple of 8 and x and `more` 16-byte aligned."""
    st = x.stride()
    vec = (x.shape[-1] if cfast else x.shape[-2]) % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, *more))
    return (st[0] if x.dim() == 5 else 0, *st[-4:]), vec


def moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mean, var (C,) in x's dtype and stats (2, C) f32 of x (N, h, w, C);
    with a fit axis, x (B, N, h, w, C), (B, C), (B, C) and (B, 2, C). x
    lies on a CUDA device."""
    b, n, h, w, c = _dims(x)
    _on_card(x=x)
    x, cfast = _layout(x)
    strides, vec = _args(x, cfast)
    rows, parts = plan(n, h, w, c, vec)
    lead = tuple(x.shape[:-4])
    part = torch.empty((b, parts, 2, c), dtype=_F32, device=x.device)
    mean = torch.empty((*lead, c), dtype=x.dtype, device=x.device)
    var = torch.empty((*lead, c), dtype=x.dtype, device=x.device)
    stats = torch.empty((*lead, 2, c), dtype=_F32, device=x.device)
    rc = _build.load().dip_up2_moments_fwd(
        x.data_ptr(), part.data_ptr(), mean.data_ptr(), var.data_ptr(), stats.data_ptr(),
        *strides, b, n, h, w, c, rows, parts, int(vec), int(cfast), int(x.dtype == _F32),
        _build.stream())
    _build.raise_on(rc, "up2 moments")
    LAUNCHES["moments_fwd"] += 1
    return mean, var, stats


def moments_bwd(x: torch.Tensor, stats: torch.Tensor, g_mean: torch.Tensor,
                g_var: torch.Tensor) -> torch.Tensor:
    """dx in x's dtype and shape from x (N, h, w, C) or (B, N, h, w, C),
    the forward's stats and the cotangents g_mean, g_var ((C,) or (B, C)),
    all on a CUDA device; dx takes x's layout where the kernels read it as
    it is."""
    b, n, h, w, c = _dims(x)
    lead = tuple(x.shape[:-4])
    if (tuple(stats.shape) != (*lead, 2, c) or tuple(g_mean.shape) != (*lead, c)
            or tuple(g_var.shape) != (*lead, c)):
        raise ValueError(f"stats {tuple(stats.shape)}, g_mean {tuple(g_mean.shape)}, g_var "
                         f"{tuple(g_var.shape)} do not fit x {tuple(x.shape)}")
    _on_card(x=x, stats=stats, g_mean=g_mean, g_var=g_var)
    x, cfast = _layout(x)
    stats = stats.to(_F32).contiguous()
    g_mean = g_mean.to(x.dtype).contiguous()
    g_var = g_var.to(x.dtype).contiguous()
    dx = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
    strides, vec = _args(x, cfast, dx)
    rows, _ = plan(n, h, w, c, vec)
    rc = _build.load().dip_up2_moments_bwd(
        x.data_ptr(), g_mean.data_ptr(), g_var.data_ptr(), stats.data_ptr(), dx.data_ptr(),
        *strides, b, n, h, w, c, rows, int(vec), int(cfast), int(x.dtype == _F32),
        _build.stream())
    _build.raise_on(rc, "up2 moments backward")
    LAUNCHES["moments_bwd"] += 1
    return dx


# -- autograd -------------------------------------------------------------------


class Up2Moments(torch.autograd.Function):
    """x (N, h, w, C) -> mean, var (C,) in x's dtype and the f32 stats
    (2, C), not differentiable; or the fits form, x (B, N, h, w, C) ->
    (B, C), (B, C), (B, 2, C). Backward: one moments_bwd launch. Under
    torch.func.vmap over B fits, the fits form on the physical tensor: one
    launch of each kernel for all the fits."""

    @staticmethod
    def forward(x: torch.Tensor):
        return moments(x)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        ctx.save_for_backward(inputs[0], output[2])
        ctx.mark_non_differentiable(output[2])
        ctx.set_materialize_grads(False)  # no zeros made for the stats' cotangent

    @staticmethod
    def backward(ctx, g_mean: torch.Tensor | None, g_var: torch.Tensor | None, _g_stats):
        x, stats = ctx.saved_tensors
        if g_mean is None and g_var is None:
            return None
        zero = stats[..., 0, :].new_zeros(())
        return moments_bwd(x, stats, zero.expand_as(g_var) if g_mean is None else g_mean,
                           zero.expand_as(g_mean) if g_var is None else g_var)

    @staticmethod
    def vmap(info, in_dims, x):
        if in_dims[0] is None:
            return Up2Moments.apply(x), (None, None, None)
        return Up2Moments.apply(x.movedim(in_dims[0], 0)), (0, 0, 0)


def up2_moments_hopper(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) of up2(x) for x (N, h, w, C) through the kernels."""
    mean, var, _ = Up2Moments.apply(x)
    return mean, var
