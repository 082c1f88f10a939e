"""The fused up2 -> conv3x3 seam's three Hopper kernels, their plain
versions, and the autograd.Function that joins them.

Counterpart of dip_tpu/ops/pallas_up_conv.py. The kernels live in
`csrc/up_conv_fwd.cu` (fwd, an mma.sync implicit GEMM with a cp.async
pipeline), `csrc/up_conv_dgrad.cu` (dgrad, the same machinery over the
phase-major dz, its reduction split as `dgrad_plan` says) and
`csrc/up_conv_wgrad.cu` (wgrad, mma.sync GEMMs over pixel tiles split as
`wgrad_plan` says; the same kernel runs K5 and K6 in bf16 for
ops/hopper_wgrad.py, split as `wgrad3x3_plan` and `wgrad_mma_plan` say); a
split reduction ends in a deterministic second pass.
They are built at first use by ops/_build.py:

  fwd    xp (N,h+2,w+2,C), e (3,3,C,4F)  -> z (N,2h,2w,F), phase -> HR
         interleave out[2r+p, 2s+q, f] = acc[r, s, (p*2+q)*F + f], plus an
         optional carry-in (N,2h,2w,F) added in the epilogue in z's dtype
  dgrad  dzq (N,h,w,4F) bf16, e          -> dxp (N,h+2,w+2,C)
  wgrad  xp, dzq                         -> de (3,3,C,4F)

The backward's HR -> phase-major transform of the cotangent dz (with its
bf16 cast) is K4, the packed space-to-depth kernel of ops/hopper_s2d.py:
the JAX package's `seam_dz='pallas'` route, one pass over dz.

The fit axis (parallel/batch.py's BatchEngine, B independent fits in one
program): each wrapper also takes a batched e (B,3,3,C,4F) with B runs of
N images in xp, dzq and the output, image n taking e[n // N], and wgrad
then gives de (B,3,3,C,4F), each fit summing only its own images. One
launch serves all B fits; the split plans are a fit's, so a fit's bits do
not depend on B, and B = 1 is the single-e launch. Under torch.func.vmap,
UpConv3x3's vmap rule calls UpConv3x3Fits on the physical tensors where e
is batched, and folds the fits into N where only xp is.

Numerics follow the TPU kernels' mixed mode (pallas_up_conv._mx): the
operands are rounded to bf16, every sum is f32, and results come back in
xp's dtype. The plain versions below do exactly that in PyTorch (round,
then compute in f32), so kernel and plain version differ only in the order
of the f32 sums.

Each wrapper takes its plain version only when every tensor it is given
lies on the CPU (with a fit axis, the plain version applied per fit). On
CUDA tensors it launches the kernel or raises; any other mix of devices
raises. Each launch adds one to `LAUNCHES`, with a fit axis or without; a
forward with a carry counts as "fwd_carry".
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dip_tpu_torch.ops import _build, hopper_s2d

LAUNCHES = {"fwd": 0, "fwd_carry": 0, "dgrad": 0, "wgrad": 0}
_BF16 = torch.bfloat16
_FLOATS = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _mx(a: torch.Tensor) -> torch.Tensor:
    """Tensor-core operand precision, as f32 for the plain versions."""
    return a.to(_BF16).to(torch.float32)


# -- plain versions -------------------------------------------------------------


def fwd_plain(xp: torch.Tensor, e: torch.Tensor,
              carry: torch.Tensor | None = None) -> torch.Tensor:
    if e.dim() == 5:  # a fit axis: each fit's images through its own e
        carries = [None] * len(e) if carry is None else carry.chunk(len(e))
        return torch.cat([fwd_plain(x, ee, cy) for x, ee, cy in
                          zip(xp.chunk(len(e)), e, carries)])
    n, hp, wp, _ = xp.shape
    h, w = hp - 2, wp - 2
    f4 = e.shape[-1]
    x, ee = _mx(xp), _mx(e)
    acc = torch.zeros((n, h, w, f4), dtype=torch.float32, device=xp.device)
    for d in range(3):
        for g in range(3):
            acc += x[:, d:d + h, g:g + w] @ ee[d, g]
    z = acc.to(xp.dtype).reshape(n, h, w, 2, 2, f4 // 4)
    z = z.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, f4 // 4)
    return z if carry is None else z + carry


def dgrad_plain(dzq: torch.Tensor, e: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    if e.dim() == 5:
        return torch.cat([dgrad_plain(d, ee, out_dtype) for d, ee in zip(dzq.chunk(len(e)), e)])
    n, h, w, _ = dzq.shape
    c = e.shape[2]
    dzp = F.pad(_mx(dzq), (0, 0, 2, 2, 2, 2))  # dacc is zero outside 0..h-1
    ee = _mx(e)
    acc = torch.zeros((n, h + 2, w + 2, c), dtype=torch.float32,
                      device=dzq.device)
    for d in range(3):
        for g in range(3):
            acc += dzp[:, 2 - d:4 - d + h, 2 - g:4 - g + w] @ ee[d, g].T
    return acc.to(out_dtype)


def wgrad_plain(xp: torch.Tensor, dzq: torch.Tensor, fits: int | None = None) -> torch.Tensor:
    """de (3,3,C,4F); with `fits`, (fits,3,3,C,4F), fit b's from its own
    images."""
    if fits is not None:
        return torch.stack([wgrad_plain(x, d) for x, d in zip(xp.chunk(fits), dzq.chunk(fits))])
    _, hp, wp, c = xp.shape
    h, w = hp - 2, wp - 2
    x, dz = _mx(xp), _mx(dzq)
    de = torch.stack([
        torch.einsum("nijc,nijk->ck", x[:, d:d + h, g:g + w], dz)
        for d in range(3) for g in range(3)])
    return de.reshape(3, 3, c, dz.shape[-1]).to(xp.dtype)


# -- kernel wrappers ------------------------------------------------------------


def _on_cpu(**tensors: torch.Tensor) -> bool:
    """_build.on_cpu, and on a CUDA device every tensor contiguous."""
    if _build.on_cpu(**tensors):
        return True
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return False


def _check_dtype(name: str, t: torch.Tensor, allowed) -> None:
    if t.dtype not in allowed:
        raise TypeError(f"{name} has dtype {t.dtype}; expected one of {allowed}")


def _fits(e: torch.Tensor, n: int) -> int:
    """The fits of a seam kernel e: 1 for (3,3,C,4F), B for (B,3,3,C,4F),
    whose B must divide the N images."""
    if e.dim() not in (4, 5) or e.shape[-4:-2] != (3, 3):
        raise ValueError(f"e (3,3,C,4F) or (B,3,3,C,4F) expected, got {tuple(e.shape)}")
    fits = 1 if e.dim() == 4 else e.shape[0]
    if fits < 1 or n % fits:
        raise ValueError(f"{fits} fits do not divide {n} images")
    return fits


def _seam_dims(xp: torch.Tensor, e: torch.Tensor) -> tuple[int, ...]:
    """(fits, N, h, w, C, F) of xp (N,h+2,w+2,C) and e (3,3,C,4F) or
    (B,3,3,C,4F)."""
    if xp.dim() != 4:
        raise ValueError(f"xp (N,h+2,w+2,C) expected, got {tuple(xp.shape)}")
    n, hp, wp, c = xp.shape
    fits = _fits(e, n)
    if e.shape[-2] != c or e.shape[-1] % 4 or hp < 4 or wp < 4:
        raise ValueError(f"bad seam shapes xp {tuple(xp.shape)}, e {tuple(e.shape)}")
    return fits, n, hp - 2, wp - 2, c, e.shape[-1] // 4


def fwd(xp: torch.Tensor, e: torch.Tensor,
        carry: torch.Tensor | None = None) -> torch.Tensor:
    """Forward seam: xp (N,h+2,w+2,C), e (3,3,C,4F) -> (N,2h,2w,F), plus
    `carry` (N,2h,2w,F) in xp's dtype when given. With e (B,3,3,C,4F),
    image n takes e[n // (N/B)]."""
    fits, n, h, w, c, f = _seam_dims(xp, e)
    _check_dtype("xp", xp, _FLOATS)
    _check_dtype("e", e, _FLOATS)
    tensors = {"xp": xp, "e": e}
    if carry is not None:
        if tuple(carry.shape) != (n, 2 * h, 2 * w, f) or carry.dtype != xp.dtype:
            raise ValueError(f"carry {tuple(carry.shape)} {carry.dtype} does not match "
                             f"the output {(n, 2 * h, 2 * w, f)} {xp.dtype}")
        tensors["carry"] = carry
    if _on_cpu(**tensors):
        return fwd_plain(xp, e, carry)
    # operands are bf16 in both modes (as _fwd's _mx): an f32 xp is rounded
    # once here, so one bf16 main loop serves both; out and carry keep xp's dtype
    xb, eb = xp.to(_BF16), e.to(_BF16)
    out = torch.empty((n, 2 * h, 2 * w, f), dtype=xp.dtype, device=xp.device)
    rc = _build.load().dip_up_conv_fwd(
        xb.data_ptr(), eb.data_ptr(), None if carry is None else carry.data_ptr(),
        out.data_ptr(), fits, n, h, w, c, f, int(xp.dtype == torch.float32), _build.stream())
    _build.raise_on(rc, "seam fwd")
    LAUNCHES["fwd" if carry is None else "fwd_carry"] += 1
    return out


_SMS = 132  # the H100 SXM's streaming multiprocessors
# dgrad's tiles (csrc/up_conv_dgrad.cu): a block owns TH x TW dxp pixels x
# BN channels and runs 9 steps (taps) for each KC-column chunk of 4F; two
# blocks an SM
_DG_TH, _DG_TW, _DG_BN, _DG_KC, _DG_BLOCKS_AN_SM = 8, 16, 128, 64, 2
# no split shorter than this many steps (measured on an H100: PERF.md §6)
_DG_MIN_STEPS = 9


class DgradPlan(NamedTuple):
    """How dgrad cuts its reduction over `steps` = 9 * ceil(4F / 64) steps
    (step t: 64-column chunk t // 9 of 4F, tap t % 9 = 3d + g): split s
    runs steps [s * steps_per_split, min((s + 1) * steps_per_split, steps))
    on `blocks` blocks (N x dxp pixel tiles x channel tiles). A split is
    whole chunks, or whole kernel rows of three taps where 4F is one chunk.
    One split stores dxp directly (`workspace` None); more write one f32
    slab of dxp's shape each into a workspace of shape `workspace`, added
    in split order."""
    blocks: int
    steps: int
    splits: int
    steps_per_split: int
    workspace: tuple[int, int, int, int, int] | None


@functools.lru_cache(maxsize=64)
def dgrad_plan(n: int, h: int, w: int, c: int, f: int) -> DgradPlan:
    """dgrad's split plan for the seam (N, h, w, C, F), from the shape alone:
    where one split fills less than a wave of blocks (two an SM), enough
    splits for about two waves, but none shorter than _DG_MIN_STEPS steps,
    and never a chunk cut in two (so no halo is staged twice). A grid that
    fills a wave is not split: more splits add waves of shorter blocks and
    f32 slabs, not concurrency (measured on an H100: PERF.md §6)."""
    steps = 9 * -(-4 * f // _DG_KC)
    unit = 9 if steps > 9 else 3
    blocks = n * -(-(h + 2) // _DG_TH) * -(-(w + 2) // _DG_TW) * -(-c // _DG_BN)
    wave = _DG_BLOCKS_AN_SM * _SMS
    want = 1 if blocks >= wave else -(-2 * wave // blocks)
    units = steps // unit
    per_units = min(units, max(-(-units // want), -(-_DG_MIN_STEPS // unit)))
    per = per_units * unit
    splits = -(-steps // per)
    workspace = (splits, n, h + 2, w + 2, c) if splits > 1 else None
    return DgradPlan(blocks, steps, splits, per, workspace)


def dgrad(dzq: torch.Tensor, e: torch.Tensor,
          out_dtype: torch.dtype) -> torch.Tensor:
    """Data gradient: phase-major dzq (N,h,w,4F) bf16 -> dxp (N,h+2,w+2,C);
    with e (B,3,3,C,4F), image n through e[n // (N/B)], split as one fit's
    N/B images are."""
    if dzq.dim() != 4 or dzq.shape[3] != e.shape[-1] or dzq.shape[3] % 4:
        raise ValueError(f"bad dgrad shapes dzq {tuple(dzq.shape)}, e {tuple(e.shape)}")
    n, h, w, f4 = dzq.shape
    fits = _fits(e, n)
    c = e.shape[-2]
    _check_dtype("dzq", dzq, (_BF16,))
    _check_dtype("e", e, _FLOATS)
    if out_dtype not in _FLOATS:
        raise TypeError(f"out_dtype {out_dtype} not supported")
    if _on_cpu(dzq=dzq, e=e):
        return dgrad_plain(dzq, e, out_dtype)
    plan = dgrad_plan(n // fits, h, w, c, f4 // 4)
    eb = e.to(_BF16)
    ws = (None if plan.workspace is None else torch.empty(
        (plan.splits, n, h + 2, w + 2, c), dtype=torch.float32, device=dzq.device))
    dxp = torch.empty((n, h + 2, w + 2, c), dtype=out_dtype, device=dzq.device)
    rc = _build.load().dip_up_conv_dgrad(
        dzq.data_ptr(), eb.data_ptr(), None if ws is None else ws.data_ptr(), dxp.data_ptr(),
        fits, n, h, w, c, f4 // 4, plan.splits, plan.steps_per_split,
        int(out_dtype == torch.float32), _build.stream())
    _build.raise_on(rc, "seam dgrad")
    LAUNCHES["dgrad"] += 1
    return dxp


# wgrad's tiles (csrc/up_conv_wgrad.cu, which also runs K5 and K6 in bf16):
# pixel tiles of TH x TW, and a block's output tile of one kernel row's
# taps (three, or one for K6) x BC channels x BK columns
_WG_TH, _WG_TW, _WG_BC, _WG_BK = 8, 16, 64, 128
# at most one split for every six pixel tiles: a split costs one f32
# (taps, C, cols) slab each way through device memory, which outweighs the
# parallelism it adds below about six tiles (measured on an H100: PERF.md §6)
_WG_TILES_A_SPLIT = 6
# waves of blocks the splits aim at, by taps: two for the 3x3, one for the
# 1x1 (measured on an H100 with `seam_times.py --waves`: PERF.md §6)
_WG_WAVES = {9: 2, 1: 1}


class WgradPlan(NamedTuple):
    """How the weight-gradient kernel cuts the N*h*w reduction: `splits`
    slices of `tiles_per_split` consecutive pixel tiles each (the last takes
    the rest), summing `pixels[s]` pixels into slab s of an f32 workspace of
    shape `workspace` (splits, taps, C, cols rounded up to 4), on a grid of
    `grid` blocks (C tiles x column tiles x kernel rows, splits)."""
    tiles: int
    splits: int
    tiles_per_split: int
    pixels: tuple[int, ...]
    grid: tuple[int, int]
    workspace: tuple[int, int, int, int]


@functools.lru_cache(maxsize=64)
def wgrad_mma_plan(n: int, h: int, w: int, c: int, cols: int, taps: int) -> WgradPlan:
    """The split plan of a VALID k x k weight gradient (taps = k*k, k = 3 or
    1) over x (N, h+k-1, w+k-1, C) and dz (N, h, w, cols), from the shape
    alone: enough splits for _WG_WAVES[taps] waves of blocks on the card's
    SMs (one block an SM), but no more than one split for every
    _WG_TILES_A_SPLIT pixel tiles."""
    if taps not in (9, 1):
        raise ValueError(f"taps must be 9 or 1, got {taps}")
    rows, tcols = -(-h // _WG_TH), -(-w // _WG_TW)
    tiles = n * rows * tcols
    blocks = -(-c // _WG_BC) * -(-cols // _WG_BK) * (3 if taps == 9 else 1)
    splits = min(-(-_WG_WAVES[taps] * _SMS // blocks), -(-tiles // _WG_TILES_A_SPLIT))
    per = -(-tiles // splits)
    splits = -(-tiles // per)
    # pixels of tile t: its valid rows times its valid columns
    tile_px = [min(_WG_TH, h - r * _WG_TH) * min(_WG_TW, w - s * _WG_TW)
               for r in range(rows) for s in range(tcols)] * n
    pixels = tuple(sum(tile_px[i * per:(i + 1) * per]) for i in range(splits))
    return WgradPlan(tiles, splits, per, pixels, (blocks, splits),
                     (splits, taps, c, -(-cols // 4) * 4))


def wgrad3x3_plan(n: int, h: int, w: int, c: int, cols: int) -> WgradPlan:
    """wgrad_mma_plan of the 3x3 weight gradient (K3, and K5 in bf16)."""
    return wgrad_mma_plan(n, h, w, c, cols, 9)


@functools.lru_cache(maxsize=64)
def wgrad_plan(n: int, h: int, w: int, c: int, f: int) -> WgradPlan:
    """wgrad's split plan for the seam (N, h, w, C, F): wgrad3x3_plan over
    the 4F phase columns."""
    return wgrad3x3_plan(n, h, w, c, 4 * f)


def wgrad(xp: torch.Tensor, dzq: torch.Tensor, fits: int | None = None) -> torch.Tensor:
    """Weight gradient of e: xp, phase-major dzq -> de (3,3,C,4F) in xp's
    dtype; with `fits` = B, de (B,3,3,C,4F), fit b's summed over its own run
    of N/B images only, split as one fit's images are."""
    if xp.dim() != 4 or dzq.dim() != 4 or dzq.shape[:3] != (
            xp.shape[0], xp.shape[1] - 2, xp.shape[2] - 2) or dzq.shape[3] % 4:
        raise ValueError(f"bad wgrad shapes xp {tuple(xp.shape)}, dzq {tuple(dzq.shape)}")
    n, hp, wp, c = xp.shape
    h, w, f4 = hp - 2, wp - 2, dzq.shape[3]
    if fits is not None and (fits < 1 or n % fits):
        raise ValueError(f"{fits} fits do not divide {n} images")
    _check_dtype("xp", xp, _FLOATS)
    _check_dtype("dzq", dzq, (_BF16,))
    if _on_cpu(xp=xp, dzq=dzq):
        return wgrad_plain(xp, dzq, fits)
    b = 1 if fits is None else fits
    plan = wgrad_plan(n // b, h, w, c, f4 // 4)
    # operands are bf16 in both modes (as _wgrad's _mx): an f32 xp is rounded
    # once here, so one bf16 main loop serves both; de keeps xp's dtype
    xb = xp.to(_BF16)
    ws = torch.empty((b, *plan.workspace), dtype=torch.float32, device=xp.device)
    de = torch.empty((3, 3, c, f4) if fits is None else (fits, 3, 3, c, f4), dtype=xp.dtype,
                     device=xp.device)
    rc = _build.load().dip_up_conv_wgrad(
        xb.data_ptr(), dzq.data_ptr(), ws.data_ptr(), de.data_ptr(), b, n, h, w, c, f4 // 4,
        plan.splits, plan.tiles_per_split, int(xp.dtype == torch.float32), _build.stream())
    _build.raise_on(rc, "seam wgrad")
    LAUNCHES["wgrad"] += 1
    return de


# -- autograd -------------------------------------------------------------------


def phase_major(dz: torch.Tensor) -> torch.Tensor:
    """HR cotangent (N,2h,2w,F) -> phase-major bf16 (N,h,w,4F), column
    (p*2+q)*F+f: the plain version of the backward's K4 launch
    (pallas_up_conv._vjp_bwd's 'xla' transform)."""
    return hopper_s2d.s2d_pack_plain(dz, _BF16)


def _batch_first(t: torch.Tensor | None, dim: int | None, size: int) -> torch.Tensor | None:
    """A vmap rule's physical tensor with its batch axis first (an
    unbatched one expanded to `size`)."""
    if t is None:
        return None
    return t.movedim(dim, 0) if dim is not None else t.expand(size, *t.shape)


def _fold(t: torch.Tensor | None) -> torch.Tensor | None:
    """(B, N, ...) -> contiguous (B*N, ...)."""
    return None if t is None else t.reshape(-1, *t.shape[2:]).contiguous()


class UpConv3x3(torch.autograd.Function):
    """Seam on the edge-padded LR input: xp (N,h+2,w+2,C), e (3,3,C,4F) ->
    interleaved HR (N,2h,2w,F), plus the carry-in if one is given;
    backward packs dz phase-major in bf16 (K4), runs dgrad and wgrad, and
    d(carry) = dz. Under torch.func.vmap over B fits, a batched e runs
    UpConv3x3Fits on the B*N images (one launch of each kernel for all the
    fits), and an unbatched e folds the fits into N."""

    @staticmethod
    def forward(xp: torch.Tensor, e: torch.Tensor, carry: torch.Tensor | None) -> torch.Tensor:
        return fwd(xp, e, carry)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        xp, e, carry = inputs
        ctx.save_for_backward(xp, e)
        ctx.has_carry = carry is not None

    @staticmethod
    def backward(ctx, dz: torch.Tensor):
        xp, e = ctx.saved_tensors
        dzq = hopper_s2d.s2d_pack(dz, _BF16)
        return (dgrad(dzq, e, xp.dtype), wgrad(xp, dzq).to(e.dtype),
                dz if ctx.has_carry else None)

    @staticmethod
    def vmap(info, in_dims, xp, e, carry):
        b = info.batch_size
        x_dim, e_dim, c_dim = in_dims
        xp = _batch_first(xp, x_dim, b)
        carry = _batch_first(carry, c_dim, b)
        n = xp.shape[1]
        if e_dim is None:
            out = UpConv3x3.apply(_fold(xp), e, _fold(carry))
        else:
            out = UpConv3x3Fits.apply(_fold(xp), e.movedim(e_dim, 0).contiguous(),
                                      _fold(carry))
        return out.reshape(b, n, *out.shape[1:]), 0


class UpConv3x3Fits(torch.autograd.Function):
    """B fits' seams at once: xp (B*N,h+2,w+2,C), e (B,3,3,C,4F), the
    carry-in (B*N,2h,2w,F) or None -> (B*N,2h,2w,F), fit b's N images
    through e[b]. One launch of K1 forward; backward one K4 over the B*N
    cotangents, one K2 and one K3 with the fit axis (de (B,3,3,C,4F), each
    fit's from its own images)."""

    @staticmethod
    def forward(xp: torch.Tensor, e: torch.Tensor, carry: torch.Tensor | None) -> torch.Tensor:
        return fwd(xp, e, carry)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        xp, e, carry = inputs
        ctx.save_for_backward(xp, e)
        ctx.has_carry = carry is not None

    @staticmethod
    def backward(ctx, dz: torch.Tensor):
        xp, e = ctx.saved_tensors
        dzq = hopper_s2d.s2d_pack(dz, _BF16)
        return (dgrad(dzq, e, xp.dtype), wgrad(xp, dzq, e.shape[0]).to(e.dtype),
                dz if ctx.has_carry else None)


def up2_conv3x3_hopper(xp: torch.Tensor, e: torch.Tensor,
                       carry: torch.Tensor | None = None) -> torch.Tensor:
    return UpConv3x3.apply(xp, e, carry)
