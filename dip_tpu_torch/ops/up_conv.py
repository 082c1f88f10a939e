"""Fused 2x-upsample -> 3x3 conv for the skip-net decoder seam.

Counterpart of dip_tpu/ops/up_conv.py. Both ops are linear, so for output
phase (p, q) in {0,1}^2

    conv3x3(up2(x))[2i+p, 2j+q] = sum_{d,g in 0..2} x[i-1+d, j-1+g] @ E[p,q,d,g]

with E[p,q,d,g] = sum_{k,l} B[p,d,k] B[q,g,l] W[k,l] mixing the conv kernel
W with the upsampler's interpolation weights B. The phases fold onto the
output dimension as a (3,3,C,4F) effective kernel e (column (p*2+q)*F+f),
and the seam becomes 9 shifted-tap matmuls on the edge-padded LR input,
which the Hopper kernels in ops/hopper_up_conv.py run; the upsampled tensor
never exists. Edge replication of the LR input reproduces up2's clamp, so
replication padding at HR is exact; reflection padding differs on the
outermost HR ring only, which _add_reflect_corrections repairs with the
unfolded kernel. Everything in this file is plain PyTorch.

Both ops take row blocks (ops/rows.Rows) too: each block's edge-padded LR
input takes one halo row from each neighbour, and the reflection
corrections and the up2 moments' edge weights fall on the image's true
first and last rows only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dip_tpu_torch.ops.consts import device_const as _const
from dip_tpu_torch.ops.hopper_up_conv import up2_conv3x3_hopper
from dip_tpu_torch.ops.rows import Rows, allsum, gather_rows, halo_blocks
from dip_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class Up2:
    """A not-yet-materialised 2x upsample of `x` (a virtual tensor part)."""

    x: torch.Tensor
    mode: str  # 'bilinear' | 'nearest'

    @property
    def shape(self):
        n, h, w, c = self.x.shape
        return (n, 2 * h, 2 * w, c)

    def affine(self, s: torch.Tensor, t: torch.Tensor) -> "Up2":
        """Per-channel affine maps commute with upsampling (the rows of B
        sum to 1), so normalise the LR tensor."""
        return Up2(self.x * s.to(self.x.dtype) + t.to(self.x.dtype), self.mode)


# 1-D phase mixing matrices B[p, d, k]: output phase p's dependence on LR
# tap d (of the edge-replicated input) through conv kernel index k.
_B_BILINEAR = np.array(
    [
        [[0.75, 0.25, 0.00],
         [0.25, 0.75, 0.75],
         [0.00, 0.00, 0.25]],
        [[0.25, 0.00, 0.00],
         [0.75, 0.75, 0.25],
         [0.00, 0.25, 0.75]],
    ],
    dtype=np.float32,
)
_B_NEAREST = np.array(
    [
        [[1.0, 0.0, 0.0],
         [0.0, 1.0, 1.0],
         [0.0, 0.0, 0.0]],
        [[0.0, 0.0, 0.0],
         [1.0, 1.0, 0.0],
         [0.0, 0.0, 1.0]],
    ],
    dtype=np.float32,
)


def _bmat(mode: str) -> np.ndarray:
    if mode == "bilinear":
        return _B_BILINEAR
    if mode == "nearest":
        return _B_NEAREST
    raise ValueError(f"unsupported upsample mode for fusion: {mode!r}")


def can_fuse_up2(mode: str, ksize: int, stride: int, pad: str, h: int,
                 w: int) -> bool:
    return (mode in ("bilinear", "nearest") and ksize == 3 and stride == 1
            and pad in ("reflection", "replication", "reflect", "edge")
            and h >= 2 and w >= 2)


def _up2_matrix(L: int) -> np.ndarray:
    """Clamped half-pixel bilinear 2x upsampling as a (2L, L) matrix."""
    U = np.zeros((2 * L, L), np.float32)
    for i in range(L):
        U[2 * i, i] += 0.75
        U[2 * i, max(i - 1, 0)] += 0.25
        U[2 * i + 1, i] += 0.75
        U[2 * i + 1, min(i + 1, L - 1)] += 0.25
    return U


def _t_band(L: int) -> np.ndarray:
    """(3, 2L, L): tap e of the reflect-padded conv after clamped up2, the
    true boundary behaviour as a banded matrix."""
    U = _up2_matrix(L)
    out = np.zeros((3, 2 * L, L), np.float32)
    for e in range(3):
        for o in range(2 * L):
            m = o + e - 1
            if m < 0:
                m = -m
            if m >= 2 * L:
                m = 2 * (2 * L - 1) - m
            out[e, o] = U[m]
    return out


def _p_band(L: int) -> np.ndarray:
    """(3, 2L, L): the replicate-padded phase operators the kernels compute
    (equal to _t_band except on the outermost HR line of each side)."""
    B = _B_BILINEAR
    out = np.zeros((3, 2 * L, L), np.float32)
    for e in range(3):
        for i in range(L):
            for p in range(2):
                for d in range(3):
                    j = min(max(i - 1 + d, 0), L - 1)
                    out[e, 2 * i + p, j] += B[p][d, e]
    return out


def _add_reflect_corrections(z: torch.Tensor, x: torch.Tensor,
                             kernel: torch.Tensor) -> torch.Tensor:
    """Reflection-pad deltas on the outermost HR ring, added in place to z
    (a fresh kernel output). kernel is the unfolded (3,3,C,F) HWIO kernel."""
    n, h, w, c = x.shape
    dt = z.dtype
    # (T_h - P_h) (x) T_w: HR rows 0 / 2h-1 through kernel rows 0 / 2
    tb = _const(_t_band, w, x.dtype, x.device)
    d_tb = 0.25 * torch.cat(
        [x[:, 1:2] - x[:, 0:1], x[:, h - 2:h - 1] - x[:, h - 1:h]], dim=1)
    k_tb = torch.stack([kernel[0], kernel[2]])            # (2, 3, C, F)
    corr = torch.einsum("eol,nrlc,recf->nrof", tb, d_tb, k_tb)
    z[:, 0:1] += corr[:, 0:1].to(dt)
    z[:, 2 * h - 1:2 * h] += corr[:, 1:2].to(dt)
    # P_h (x) (T_w - P_w): HR cols 0 / 2w-1 through kernel cols 0 / 2, with
    # the replicate phase operator along H (the rows above own the corners)
    pb = _const(_p_band, h, x.dtype, x.device)
    d_lr = 0.25 * torch.cat(
        [x[:, :, 1:2] - x[:, :, 0:1], x[:, :, w - 2:w - 1] - x[:, :, w - 1:w]],
        dim=2).permute(0, 2, 1, 3)                        # (N, 2, h, C)
    k_lr = torch.stack([kernel[:, 0], kernel[:, 2]])      # (2, 3, C, F)
    corr = torch.einsum("eol,nrlc,recf->nrof", pb, d_lr, k_lr)
    corr = corr.permute(0, 2, 1, 3)                       # (N, 2h, 2, F)
    z[:, :, 0:1] += corr[:, :, 0:1].to(dt)
    z[:, :, 2 * w - 1:2 * w] += corr[:, :, 1:2].to(dt)
    return z


def effective_kernel(kernel: torch.Tensor, up_mode: str) -> torch.Tensor:
    """The seam kernels' (3,3,C,4F) e of the HWIO (3,3,C,F) conv kernel:
    E[p,q,d,g] = sum_{k,l} B[p,d,k] B[q,g,l] W[k,l], column (p*2+q)*F+f."""
    c, f = kernel.shape[2:]
    bj = _const(_bmat, up_mode, kernel.dtype, kernel.device)
    e = torch.einsum("pdk,qel,klcf->decpqf", bj, bj, kernel)
    return e.reshape(3, 3, c, 4 * f).contiguous()


def up2_conv3x3(x: torch.Tensor | Rows, kernel: torch.Tensor,
                up_mode: str = "bilinear",
                pad_mode: str = "reflection",
                carry: torch.Tensor | Rows | None = None) -> torch.Tensor | Rows:
    """conv_valid(pad1_{pad_mode}(upsample(x, 2, up_mode)), kernel), fused.

    x: (N, h, w, C), kernel: HWIO (3, 3, C, F) -> (N, 2h, 2w, F). No bias.
    `carry` (the output's shape, x's dtype) is added in the forward
    kernel's epilogue; the reflection corrections come after it.
    """
    with span("dip.kernels.seam"):
        if kernel.shape[:3] != (3, 3, x.shape[3]):
            raise ValueError(f"kernel {tuple(kernel.shape)} does not fit x {tuple(x.shape)}")
        if isinstance(x, Rows):
            return _up2_conv3x3_rows(x, kernel, up_mode, pad_mode, carry)
        e = effective_kernel(kernel, up_mode)
        xp = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)
        xp = torch.cat([xp[:, :, :1], xp, xp[:, :, -1:]], dim=2)
        z = up2_conv3x3_hopper(xp, e, None if carry is None else carry.contiguous())
        if up_mode == "bilinear" and pad_mode in ("reflection", "reflect"):
            z = _add_reflect_corrections(z, x, kernel)
        return z


def _p_band_halo(h: int) -> np.ndarray:
    """(3, 2h, h+2): _p_band of one row block read from its rows with a
    halo row on each side (image row start-1+j at column j), so no clamp:
    the halo rows carry the image's edge replication at its true top and
    bottom and the neighbours' rows elsewhere."""
    out = np.zeros((3, 2 * h, h + 2), np.float32)
    for e in range(3):
        for i in range(h):
            for p in range(2):
                for d in range(3):
                    out[e, 2 * i + p, i + d] += _B_BILINEAR[p][d, e]
    return out


def _block_corrections(z: torch.Tensor, xr: torch.Tensor, kernel: torch.Tensor,
                       top: bool, bottom: bool) -> torch.Tensor:
    """_add_reflect_corrections for one row block: xr is the block's LR
    rows with a halo row on each side (edge-replicated at the image's true
    top and bottom). The HR row corrections apply at the image's true first
    and last rows only; the column corrections to every row of the block,
    through its halo rows."""
    n, hp, w, c = xr.shape
    h = hp - 2
    dt = z.dtype
    if top or bottom:
        tb = _const(_t_band, w, xr.dtype, xr.device)
        for at, d_tb, kr, hr in ((top, xr[:, 2:3] - xr[:, 1:2], 0, 0),
                                 (bottom, xr[:, h - 1:h] - xr[:, h:h + 1], 2, 2 * h - 1)):
            if at:
                corr = torch.einsum("eol,nrlc,recf->nrof", tb, 0.25 * d_tb, kernel[kr][None])
                z[:, hr:hr + 1] += corr.to(dt)
    pb = _const(_p_band_halo, h, xr.dtype, xr.device)
    d_lr = 0.25 * torch.cat(
        [xr[:, :, 1:2] - xr[:, :, 0:1], xr[:, :, w - 2:w - 1] - xr[:, :, w - 1:w]],
        dim=2).permute(0, 2, 1, 3)                        # (N, 2, h+2, C)
    k_lr = torch.stack([kernel[:, 0], kernel[:, 2]])      # (2, 3, C, F)
    corr = torch.einsum("eol,nrlc,recf->nrof", pb, d_lr, k_lr).permute(0, 2, 1, 3)
    z[:, :, 0:1] += corr[:, :, 0:1].to(dt)
    z[:, :, 2 * w - 1:2 * w] += corr[:, :, 1:2].to(dt)
    return z


def _up2_conv3x3_rows(x: Rows, kernel: torch.Tensor, up_mode: str, pad_mode: str,
                      carry: Rows | None) -> Rows:
    """up2_conv3x3 over row blocks: K1-K4 run once a block, on its LR rows
    with one halo row a side. Raises for a block of fewer than 2 LR rows
    (the seam kernels' least h)."""
    e = effective_kernel(kernel, up_mode)
    last = len(x.blocks) - 1
    out = []
    for k, xr in enumerate(halo_blocks(x, 1, 1, "replicate")):
        hk, dev = xr.shape[1] - 2, xr.device
        if hk < 2:
            raise ValueError(f"a row block of {hk} LR row at a fused seam: the seam kernels "
                             f"need 2; use fewer shards or a taller image")
        xp = torch.cat([xr[:, :, :1], xr, xr[:, :, -1:]], dim=2)
        z = up2_conv3x3_hopper(xp, e.to(dev),
                               None if carry is None else carry.blocks[k].contiguous())
        if up_mode == "bilinear" and pad_mode in ("reflection", "reflect"):
            z = _block_corrections(z, xr, kernel.to(dev), k == 0, k == last)
        out.append(z)
    return Rows(out)


def _gram_diag(L: int) -> np.ndarray:
    """The diagonal of U^T U for the (2L, L) bilinear up2 matrix U."""
    g = np.full(L, 1.25, np.float32)
    g[0] = g[-1] = 1.625
    return g


def up2_moments(x: torch.Tensor | Rows, up_mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-channel (mean, var) of upsample(x, 2, up_mode) over
    (N, H, W), computed on the LR tensor with f32 sums and returned in x's
    dtype. bilinear: the mean is mean(x); the second moment is the banded
    quadratic form with G = U^T U, G[i,i] = 1.25 (1.625 at the two edges),
    G[i,i+1] = 0.375. Its products are taken in f32, as _moments in
    models/blocks.py takes them, and the variance is clamped at 0: with
    products rounded to bf16 (the JAX package's form), a channel whose
    variance is a thousandth of its squared mean came out negative and
    BN's rsqrt made the fit NaN (flash/no-flash at lr 0.1 in bf16)."""
    with span("dip.kernels.seam"):
        f32 = torch.float32
        if isinstance(x, Rows):
            return _up2_moments_rows(x, up_mode)
        if up_mode == "nearest":
            xf = x.to(f32)
            return (xf.mean((0, 1, 2)).to(x.dtype),
                    xf.var((0, 1, 2), unbiased=False).to(x.dtype))
        if up_mode != "bilinear":
            raise ValueError(f"unsupported upsample mode for moments: {up_mode!r}")
        n, h, w, c = x.shape
        if h < 2 or w < 2:
            raise ValueError(f"up2_moments needs h, w >= 2, got {h}x{w}")
        xf = x.to(f32)
        mean = xf.mean((0, 1, 2))
        g0h = _const(_gram_diag, h, f32, x.device)
        g0w = _const(_gram_diag, w, f32, x.device)
        s0 = torch.einsum("nhwc,h,w->c", xf * xf, g0h, g0w)
        sh = 0.75 * torch.einsum("nhwc,w->c", xf[:, :-1] * xf[:, 1:], g0w)
        sw = 0.75 * torch.einsum("nhwc,h->c", xf[:, :, :-1] * xf[:, :, 1:], g0h)
        sd = 0.28125 * ((xf[:, :-1, :-1] * xf[:, 1:, 1:]).sum((0, 1, 2))
                        + (xf[:, 1:, :-1] * xf[:, :-1, 1:]).sum((0, 1, 2)))
        second = (s0 + sh + sw + sd) / (n * 4 * h * w)
        var = torch.clamp(second - mean * mean, min=0.0)
        return mean.to(x.dtype), var.to(x.dtype)


def _up2_moments_rows(x: Rows, up_mode: str) -> tuple[torch.Tensor, torch.Tensor]:
    """up2_moments over row blocks: each block's f32 sums, with one halo
    row below it for the bilinear form's vertical and diagonal neighbour
    products, added on block 0's device (the all-reduce)."""
    f32 = torch.float32
    n, h, w, c = x.shape
    dev0 = x.blocks[0].device
    xfs = [b.to(f32) for b in x.blocks]
    mean = allsum([xf.sum((0, 1, 2)) for xf in xfs], dev0) / (n * h * w)
    if up_mode == "nearest":
        var = allsum([((xf - mean.to(xf.device)) ** 2).sum((0, 1, 2)) for xf in xfs],
                     dev0) / (n * h * w)
        return mean.to(x.dtype), var.to(x.dtype)
    if up_mode != "bilinear":
        raise ValueError(f"unsupported upsample mode for moments: {up_mode!r}")
    if h < 2 or w < 2:
        raise ValueError(f"up2_moments needs h, w >= 2, got {h}x{w}")
    terms = []
    for k, xf in enumerate(xfs):
        dev, start, hk = xf.device, x.starts[k], xf.shape[1]
        g0h = _const(_gram_diag, h, f32, dev)[start:start + hk]
        g0w = _const(_gram_diag, w, f32, dev)
        # this block's rows and the next block's first (none below the image)
        xb = gather_rows(x, k, start, min(start + hk + 1, h), "constant").to(f32)
        s0 = torch.einsum("nhwc,h,w->c", xf * xf, g0h, g0w)
        sh = 0.75 * torch.einsum("nhwc,w->c", xb[:, :-1] * xb[:, 1:], g0w)
        sw = 0.75 * torch.einsum("nhwc,h->c", xf[:, :, :-1] * xf[:, :, 1:], g0h)
        sd = 0.28125 * ((xb[:, :-1, :-1] * xb[:, 1:, 1:]).sum((0, 1, 2))
                        + (xb[:, 1:, :-1] * xb[:, :-1, 1:]).sum((0, 1, 2)))
        terms.append(s0 + sh + sw + sd)
    second = allsum(terms, dev0) / (n * 4 * h * w)
    var = torch.clamp(second - mean * mean, min=0.0)
    return mean.to(x.dtype), var.to(x.dtype)
