"""Spatial padding for NHWC (or HWC) tensors: zero, reflection, replication.

Counterpart of dip_tpu/ops/pad.py. The forward is `F.pad`'s. Reflection
and replication take the backward below, which folds the padded strips
back onto the input with plain adds, as the JAX package's hand-written VJP
does: `F.pad`'s own CUDA backward adds every padded pixel with an atomic
add, in no fixed order, so the gradient at pixels that more than two
padded pixels mirror onto differs from run to run, and a fit on the card
would not repeat itself bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

_MODES = {
    "zero": "constant",
    "constant": "constant",
    "reflection": "reflect",
    "reflect": "reflect",
    "replication": "replicate",
    "replicate": "replicate",
    "edge": "replicate",
}


def _fold(g: torch.Tensor, p: int, dim: int, mode: str) -> torch.Tensor:
    """The adjoint of padding dimension `dim` by p on each side: the
    centre, plus each strip added onto the pixels it copied."""
    if p == 0:
        return g
    n = g.shape[dim] - 2 * p
    out = g.narrow(dim, p, n).contiguous()
    lo, hi = g.narrow(dim, 0, p), g.narrow(dim, p + n, p)
    if mode == "reflect":  # padded p-1-k and p+n+k copy input 1+k and n-2-k
        out.narrow(dim, 1, p).add_(lo.flip(dim))
        out.narrow(dim, n - 1 - p, p).add_(hi.flip(dim))
    else:  # replicate: every padded pixel copies the edge
        out.narrow(dim, 0, 1).add_(lo.sum(dim, keepdim=True))
        out.narrow(dim, n - 1, 1).add_(hi.sum(dim, keepdim=True))
    return out


class _EdgePad(torch.autograd.Function):
    """Reflection or replication padding of NHWC x by (ph, pw), with a
    deterministic backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, ph: int, pw: int, mode: str) -> torch.Tensor:
        ctx.pads, ctx.mode = (ph, pw), mode
        return F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph), mode=mode).permute(0, 2, 3, 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        ph, pw = ctx.pads
        return _fold(_fold(g, pw, 2, ctx.mode), ph, 1, ctx.mode), None, None, None


def pad2d(x: torch.Tensor, pad: int | tuple[int, int],
          mode: str = "zero") -> torch.Tensor:
    """Pad the spatial dims (H, W) of an NHWC or HWC tensor."""
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    if ph == 0 and pw == 0:
        return x
    if mode not in _MODES:
        raise ValueError(f"unknown pad mode {mode!r}")
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    if _MODES[mode] == "constant":
        y = F.pad(x4.permute(0, 3, 1, 2), (pw, pw, ph, ph)).permute(0, 2, 3, 1)
    else:
        y = _EdgePad.apply(x4, ph, pw, _MODES[mode])
    return y if x.dim() == 4 else y.squeeze(0)
