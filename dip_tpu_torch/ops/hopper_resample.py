"""The anti-aliased downsampler's Hopper kernel (counterpart of
dip_tpu/ops/pallas_resample.py's `downsample_fused`).

The kernel lives in `csrc/resample.cu` (built at first use by
ops/_build.py). It takes the unpadded NHWC f32 input, the f32 profile
taps, and a row pad p_h and a column pad p_w of their own. Each block
stages its input window (the replication pre-pad folded into clamped
indices) in shared memory once, then runs the H pass and the strided W
pass from there:

  out[n, o, q, c] = sum_{i,j} k[i] k[j] x[n, clamp(o*f + i - p_h), clamp(q*f + j - p_w), c]

A row block of a sharded fit (ops/resample.py's `downsample` over Rows)
brings its halo rows with it and runs at p_h = 0, p_w = p.

Its plain version is ops/resample.py's `downsample_plain`. This wrapper
takes CUDA tensors only and raises on anything else; each launch adds one
to `LAUNCHES["downsample"]`. `tile_plan` chooses the grid.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dip_tpu_torch.ops import _build

LAUNCHES = {"downsample": 0}
SMEM_MAX = 232448  # 227 KB: the most shared memory a block may opt in to on sm_90
SMEM_SHARE = SMEM_MAX // 2  # a plan that fits this leaves room for two blocks an SM
MIN_BLOCKS = 132  # one block on each SM of an H100
ROWS = 4  # outputs a thread sums in either pass (kRows); tiles are multiples of it
TILES = (4, 8, 16)


def reset_launches() -> None:
    LAUNCHES["downsample"] = 0


class Plan(NamedTuple):
    tile_h: int  # output rows of a block
    tile_w: int  # output columns of a block
    cg: int  # channels of a block
    smem: int  # shared bytes of a block
    blocks: int  # blocks of the grid


def window(tile: int, factor: int, ksize: int) -> int:
    """Input rows (or columns) under `tile` output rows (or columns)."""
    return (tile - 1) * factor + ksize


def inter_pitch(win_w: int, cg: int) -> int:
    """Floats of one H-pass row in shared memory: win_w pixels of cg
    channels, padded to cg mod 32 so the W pass's rows fall on distinct
    banks."""
    row = win_w * cg
    return row if cg >= 32 else row + (cg - row) % 32


def smem_bytes(tile_h: int, tile_w: int, cg: int, factor: int, ksize: int) -> int:
    """The window, the H pass's rows and the taps, as csrc/resample.cu's
    smem_floats."""
    win_w = window(tile_w, factor, ksize)
    return 4 * (window(tile_h, factor, ksize) * win_w * cg + tile_h * inter_pitch(win_w, cg)
                + ksize)


@functools.lru_cache(maxsize=None)
def tile_plan(ksize: int, factor: int, n: int, c: int, h_out: int, w_out: int) -> Plan:
    """The grid of one launch: output tiles of 4, 8 or 16 rows and columns,
    and a channel group of each block. Up to 4 channels a block takes them
    all, so that a window row is one contiguous run; above, it takes 32 or
    16 (at least 64 bytes of each pixel, two sectors of a line) where that
    gives MIN_BLOCKS blocks, else 8 or 4; one channel only if no plan fits
    half of 227 KB (two blocks an SM). The first of those tiers in which
    some plan launches at least MIN_BLOCKS blocks gives the one that
    stages the fewest window floats in all, then runs the fewest H-pass
    items (the widest tiles), then has the widest channel group and the
    fewest blocks. If none does, the plan with the most blocks (then the
    fewest floats) of the tiers that fit."""
    groups = [g for g in (32, 16, 8, 4) if g <= c] if c > 4 else [c]
    wide = [g for g in groups if g >= 16] or groups
    most = None
    for limit, cgs in ((SMEM_SHARE, wide), (SMEM_SHARE, groups), (SMEM_MAX, groups + [1])):
        if limit == SMEM_MAX and most is not None:
            break
        plans = []
        for cg in dict.fromkeys(cgs):
            for th in TILES:
                for tw in TILES:
                    smem = smem_bytes(th, tw, cg, factor, ksize)
                    if smem > limit:
                        continue
                    blocks = n * -(-h_out // th) * -(-w_out // tw) * -(-c // cg)
                    win_h, win_w = window(th, factor, ksize), window(tw, factor, ksize)
                    cost = (blocks * win_h * win_w * cg, blocks * th // ROWS * win_w * cg, -cg,
                            blocks)
                    plans.append((Plan(th, tw, cg, smem, blocks), cost))
        full = [p for p in plans if p[0].blocks >= MIN_BLOCKS]
        if full:
            return min(full, key=lambda p: p[1])[0]
        if plans:
            best = min(plans, key=lambda p: (-p[0].blocks, p[1]))[0]
            most = best if most is None or best.blocks > most.blocks else most
    if most is None:
        raise ValueError(f"a {ksize}-tap kernel at factor {factor} does not fit the "
                         f"downsample kernel's shared memory")
    return most


def downsample_fused(x: torch.Tensor, taps: torch.Tensor, factor: int,
                     pad: int | tuple[int, int], h_out: int, w_out: int) -> torch.Tensor:
    """x (N,H,W,C) f32 contiguous on a CUDA device, taps (K,) f32 on the
    same device, `pad` one pre-pad for both axes or (row pad, column pad)
    -> (N, h_out, w_out, C) f32."""
    if x.device.type != "cuda" or taps.device != x.device:
        raise ValueError(f"downsample kernel needs x and taps on one CUDA device, got "
                         f"{x.device} and {taps.device}")
    if x.dtype != torch.float32 or taps.dtype != torch.float32:
        raise TypeError(f"downsample kernel takes float32, got {x.dtype} and {taps.dtype}")
    if x.dim() != 4 or taps.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"contiguous NHWC x and 1-D taps expected, got "
                         f"{tuple(x.shape)} and {tuple(taps.shape)}")
    n, h, w, c = x.shape
    ksize = taps.shape[0]
    pad_h, pad_w = (pad, pad) if isinstance(pad, int) else pad
    if (h + 2 * pad_h - ksize) // factor + 1 != h_out or (
            w + 2 * pad_w - ksize) // factor + 1 != w_out or h_out < 1 or w_out < 1:
        raise ValueError(f"bad downsample geometry: {tuple(x.shape)}, K={ksize}, "
                         f"f={factor}, pads=({pad_h}, {pad_w}) -> {h_out}x{w_out}")
    if n > 65535:
        raise ValueError(f"downsample grid too large for N={n}")
    plan = tile_plan(ksize, factor, n, c, h_out, w_out)
    out = torch.empty((n, h_out, w_out, c), dtype=torch.float32, device=x.device)
    rc = _build.load().dip_downsample(
        x.data_ptr(), taps.data_ptr(), out.data_ptr(), n, h, w, c, h_out, w_out,
        factor, ksize, pad_h, pad_w, plan.tile_h, plan.tile_w, plan.cg, _build.stream())
    _build.raise_on(rc, "downsample")
    LAUNCHES["downsample"] += 1
    return out
