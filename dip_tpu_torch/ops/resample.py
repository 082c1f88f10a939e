"""Spatial resampling of NHWC tensors (counterpart of dip_tpu/ops/resample.py
and dip_tpu/ops/pallas_resample.py).

`upsample` is the decoder's 2x resize; it, the pools and `downsample`
take row blocks (ops/rows.Rows) too. `downsample` is the anti-aliased
downsampler, the differentiable degradation operator of super-resolution
and the Lanczos post-down of a Conv:

  - kernel construction (`resample_kernel_1d`, `resample_kernel_2d`) is
    host numpy in float64, as in the JAX package. Every family it supports
    (lanczos, gauss, box) is separable, so the 2-D kernel is the outer
    product of one 1-D profile;
  - `downsample_plain` is the replication pre-pad followed by two banded
    f32 products, y = S_h . X . S_w^T per channel, where the band matrix
    S[o, i] = k[i - o*f] is the stride-f correlation with the profile k.
    The rows and the columns take a pad each (`pads`): a row block brings
    its own halo rows and is padded along W only;
  - `downsample` is the public, differentiable op. On CPU tensors its
    forward is `downsample_plain`; on a CUDA tensor it launches the Hopper
    kernel (ops/hopper_resample.py) or raises. Its backward is PyTorch on
    both devices, as the JAX package computes this backward with XLA.
    Over row blocks, each block gathers the rows its output rows read
    (`gather_rows` in 'replicate' mode: the halo from its neighbours, the
    replication pad itself at the image's true top and bottom) and runs
    the op with row pad 0.

The profile taps and the band matrices are built once per configuration,
length, dtype and device and kept there (ops/consts.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dip_tpu_torch.ops import hopper_resample
from dip_tpu_torch.ops.consts import device_const
from dip_tpu_torch.ops.pad import pad2d
from dip_tpu_torch.ops.rows import Rows, halo_blocks
from dip_tpu_torch.utils.profiling import span


def upsample(x: torch.Tensor | Rows, scale: int = 2, mode: str = "nearest"):
    """'nearest' duplicates pixels; 'bilinear' uses half-pixel centres
    (`align_corners=False`), the resize the JAX package implements. Over
    row blocks, bilinear resizes each block with a halo row a side (edge
    replication at the image's true top and bottom, the resize's clamp)
    and cuts the halo's output rows off."""
    with span("dip.model.up"):
        if isinstance(x, Rows):
            if mode == "nearest":
                return x.map(lambda b: upsample(b, scale, mode))
            return Rows([upsample(xr, scale, mode)[:, scale:-scale]
                         for xr in halo_blocks(x, 1, 1, "replicate")])
        if mode == "nearest":
            y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale, mode="nearest")
        elif mode == "bilinear":
            y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=scale,
                              mode="bilinear", align_corners=False)
        else:
            raise ValueError(f"unknown upsample mode {mode!r}")
        return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor | Rows, window: int, stride: int | None = None):
    """Mean over `window` x `window` NHWC windows, VALID; per block over
    row blocks whose heights the stride divides."""
    if isinstance(x, Rows):
        return x.map(lambda b: avg_pool(b, window, stride))
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, window if stride is None else stride)
    return y.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor | Rows, window: int, stride: int | None = None):
    """Max over `window` x `window` NHWC windows, VALID; per block over
    row blocks whose heights the stride divides."""
    if isinstance(x, Rows):
        return x.map(lambda b: max_pool(b, window, stride))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, window if stride is None else stride)
    return y.permute(0, 2, 3, 1)


# -- kernel construction (host numpy) ---------------------------------------------


def _resolve_kernel_family(kernel_type: str, factor: int):
    """Map the named presets to (family, width, support, sigma)."""
    if kernel_type == "lanczos2":
        return "lanczos", 4 * factor + 1, 2, None
    if kernel_type == "lanczos3":
        return "lanczos", 6 * factor + 1, 3, None
    if kernel_type == "gauss12":
        return "gauss", 7, None, 0.5
    if kernel_type == "gauss1sq2":
        return "gauss", 9, None, 1.0 / np.sqrt(2)
    if kernel_type in ("lanczos", "gauss", "box"):
        return kernel_type, None, None, None
    raise ValueError(f"unknown kernel type {kernel_type!r}")


def resample_kernel_1d(factor: int, kernel_type: str = "lanczos2", phase: float = 0.0,
                       kernel_width: int | None = None, support: int | None = None,
                       sigma: float | None = None) -> np.ndarray:
    """The normalised 1-D resampling profile (float64). Phase 0.5 shrinks
    the kernel by one tap and samples at half-pixel offsets; box is always
    half-phased; gauss halves its distances, as the reference does."""
    if phase not in (0, 0.5):
        raise ValueError("phase must be 0 or 0.5")
    family, w, sup, sig = _resolve_kernel_family(kernel_type, factor)
    kernel_width = kernel_width if w is None else w
    support = support if sup is None else sup
    sigma = sigma if sig is None else sig
    if kernel_width is None:
        raise ValueError("kernel_width required for generic kernel types")

    size = kernel_width - 1 if (phase == 0.5 and family != "box") else kernel_width
    i = np.arange(1, size + 1, dtype=np.float64)
    center = (kernel_width + 1) / 2.0
    if family == "box":
        if phase != 0.5:
            raise ValueError("box filter is always half-phased")
        k = np.full(size, 1.0 / kernel_width)
    elif family == "gauss":
        if not sigma:
            raise ValueError("sigma not specified")
        if phase == 0.5:
            raise ValueError("phase 1/2 for gauss not implemented")
        d = (i - center) / 2.0
        k = np.exp(-(d * d) / (2 * sigma * sigma)) / np.sqrt(2.0 * np.pi * sigma * sigma)
    else:
        if not support:
            raise ValueError("support not specified")
        d = np.abs(i + 0.5 - center) / factor if phase == 0.5 else np.abs(i - center) / factor
        k = np.ones(size)
        nz = d != 0
        dnz = d[nz]
        k[nz] = (support * np.sin(np.pi * dnz) * np.sin(np.pi * dnz / support)
                 / (np.pi * np.pi * dnz * dnz))
    return (k / k.sum()).astype(np.float64)


def resample_kernel_2d(factor: int, kernel_type: str = "lanczos2", phase: float = 0.0,
                       kernel_width: int | None = None, support: int | None = None,
                       sigma: float | None = None) -> np.ndarray:
    """Dense 2-D kernel, the outer product of the 1-D profile."""
    k1 = resample_kernel_1d(factor, kernel_type, phase, kernel_width, support, sigma)
    return np.outer(k1, k1)


def _band_matrix(k: np.ndarray, n_in: int, n_out: int, stride: int) -> np.ndarray:
    """(n_out, n_in) f32: S[o, o*stride : o*stride + K] = k."""
    s = np.zeros((n_out, n_in), dtype=np.float32)
    for o in range(n_out):
        s[o, o * stride:o * stride + k.shape[0]] = k
    return s


# -- device constants, one per configuration ----------------------------------------
# `spec` is (factor, kernel_type, phase, kernel_width, support, sigma).


@functools.lru_cache(maxsize=None)
def _profile(spec: tuple) -> np.ndarray:
    """The f32 taps of a configuration (read-only; do not modify)."""
    return resample_kernel_1d(*spec).astype(np.float32)


def pad_width(ksize: int, factor: int, preserve_size: bool) -> int:
    """Replication pre-pad: (K-1)/2 for odd K, (K-factor)/2 for even K."""
    if not preserve_size:
        return 0
    return (ksize - 1) // 2 if ksize % 2 == 1 else (ksize - factor) // 2


def _band(key: tuple) -> np.ndarray:
    """Band matrix of `spec` over a padded input length n_in."""
    spec, n_in = key
    k = _profile(spec)
    return _band_matrix(k, n_in, (n_in - k.shape[0]) // spec[0] + 1, spec[0])


def _adjoint_band(key: tuple) -> np.ndarray:
    """S . P for an unpadded length n with pad p: the band matrix times the
    (n+2p, n) replication matrix P, whose transpose folds the padded
    gradient's edge rows into rows 0 and n-1."""
    spec, n, p = key
    s = _band((spec, n + 2 * p))
    folded = s[:, p:p + n].copy()
    folded[:, 0] += s[:, :p].sum(1)
    folded[:, n - 1] += s[:, p + n:].sum(1)
    return folded


def _spec(factor, kernel_type, phase, kernel_width, support, sigma) -> tuple:
    return (int(factor), kernel_type, float(phase), kernel_width, support, sigma)


def _out_size(shape, spec: tuple, pads: tuple[int, int]) -> tuple[int, int]:
    """(h_out, w_out) under the row and column pads; raises if the output
    would be empty."""
    if len(shape) != 4:
        raise ValueError(f"NHWC input expected, got shape {tuple(shape)}")
    ksize, factor = _profile(spec).shape[0], spec[0]
    h_out = (shape[1] + 2 * pads[0] - ksize) // factor + 1
    w_out = (shape[2] + 2 * pads[1] - ksize) // factor + 1
    if h_out < 1 or w_out < 1:
        raise ValueError(f"downsample of {tuple(shape)} by {factor} with a {ksize}-tap "
                         f"kernel (pads {pads}) is empty")
    return h_out, w_out


def _geometry(shape, spec: tuple, preserve_size: bool) -> tuple[int, int, int]:
    """(pad, h_out, w_out), one pad on both axes; raises if the output would
    be empty."""
    p = pad_width(_profile(spec).shape[0], spec[0], preserve_size)
    return (p, *_out_size(shape, spec, (p, p)))


# -- plain version and the differentiable op ------------------------------------------


def downsample_plain(x: torch.Tensor, factor: int, kernel_type: str = "lanczos2",
                     phase: float = 0.5, preserve_size: bool = False,
                     kernel_width: int | None = None, support: int | None = None,
                     sigma: float | None = None,
                     pads: tuple[int, int] | None = None) -> torch.Tensor:
    """K7's plain version: replication pre-pad by `pads` (rows, columns;
    default preserve_size's pad on both), then S_h . X . S_w^T as two
    banded products in x's dtype (full f32 for f32: no TF32)."""
    spec = _spec(factor, kernel_type, phase, kernel_width, support, sigma)
    if pads is None:
        p = _geometry(x.shape, spec, preserve_size)[0]
        pads = (p, p)
    _out_size(x.shape, spec, pads)
    xp = pad2d(x, pads, "replication")
    s_h = device_const(_band, (spec, xp.shape[1]), x.dtype, x.device)
    s_w = device_const(_band, (spec, xp.shape[2]), x.dtype, x.device)
    y = torch.einsum("oh,nhwc->nowc", s_h, xp)
    return torch.einsum("pw,nowc->nopc", s_w, y)


class _Downsample(torch.autograd.Function):
    """Forward: the plain version on the CPU, the Hopper kernel on a CUDA
    tensor, with `pads` = (row pad, column pad). Backward (linear, so
    independent of x): dX = (S_h P_h)^T . g . (S_w P_w), the adjoint of the
    banded products with each axis's replication pad's fold built into the
    cached matrices. Under torch.func.vmap the fits fold into N: one kernel
    launch for all of them."""

    @staticmethod
    def forward(x: torch.Tensor, spec: tuple, pads: tuple[int, int]) -> torch.Tensor:
        h_out, w_out = _out_size(x.shape, spec, pads)
        if x.device.type == "cpu":
            return downsample_plain(x, spec[0], spec[1], spec[2], False, *spec[3:], pads=pads)
        taps = device_const(_profile, spec, torch.float32, x.device)
        return hopper_resample.downsample_fused(x.contiguous(), taps, spec[0], pads, h_out,
                                                w_out)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        x, spec, pads = inputs
        ctx.spec, ctx.hw, ctx.pads = spec, (x.shape[1], x.shape[2]), pads

    @staticmethod
    def vmap(info, in_dims, x, spec, pads):
        x = x.movedim(in_dims[0], 0)
        out = _Downsample.apply(x.reshape(-1, *x.shape[2:]), spec, pads)
        return out.reshape(x.shape[0], -1, *out.shape[1:]), 0

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (h, w), (p_h, p_w) = ctx.hw, ctx.pads
        a_h = device_const(_adjoint_band, (ctx.spec, h, p_h), g.dtype, g.device)
        a_w = device_const(_adjoint_band, (ctx.spec, w, p_w), g.dtype, g.device)
        d = torch.einsum("oh,nowc->nhwc", a_h, g)
        return torch.einsum("pw,nhpc->nhwc", a_w, d), None, None


def _downsample_rows(x: Rows, spec: tuple, preserve_size: bool) -> Rows:
    """downsample over row blocks: block k owns the output rows of its own
    rows, [start_k / f, end_k / f), which read the pre-padded rows
    [start_k, end_k - f + K), image rows p before that; it gathers them
    ('replicate': the halo, or the pre-pad at the image's edge) and runs
    the op with row pad 0 and column pad p. Needs the even-K preserve-size
    pad (2p = K - f, the Lanczos post-down's) and block heights that f
    divides."""
    ksize, factor = _profile(spec).shape[0], spec[0]
    p = pad_width(ksize, factor, preserve_size)
    if 2 * p != ksize - factor or any(h % factor for h in x.heights):
        raise ValueError(f"row blocks of {x.heights} rows: a {ksize}-tap downsample by "
                         f"{factor} over row blocks needs a pre-pad of (K - f) / 2 and block "
                         f"heights that {factor} divides")
    return Rows([_Downsample.apply(xr, spec, (0, p))
                 for xr in halo_blocks(x, p, ksize - factor - p, "replicate")])


def downsample(x: torch.Tensor | Rows, factor: int, kernel_type: str = "lanczos2",
               phase: float = 0.5, preserve_size: bool = False,
               kernel_width: int | None = None, support: int | None = None,
               sigma: float | None = None):
    """Anti-aliased downsample of NHWC `x` by the integer `factor`:
    optional replication pre-pad, then the stride-`factor` correlation with
    the normalised separable kernel. Differentiable in x."""
    spec = _spec(factor, kernel_type, phase, kernel_width, support, sigma)
    if isinstance(x, Rows):
        return _downsample_rows(x, spec, preserve_size)
    p = _geometry(x.shape, spec, preserve_size)[0]
    return _Downsample.apply(x, spec, (p, p))
