"""The anti-aliased downsampler's Hopper kernel (counterpart of
dip_tpu/ops/pallas_resample.py's `downsample_fused`).

The kernel lives in `csrc/resample.cu` (built at first use by
ops/_build.py). It takes the unpadded NHWC f32 input and the f32 profile
taps, folds the replication pre-pad into clamped load indices, and keeps
the H pass's rows in shared memory for the strided W pass:

  out[n, o, q, c] = sum_{i,j} k[i] k[j] x[n, clamp(o*f + i - p), clamp(q*f + j - p), c]

Its plain version is ops/resample.py's `downsample_plain`. This wrapper
takes CUDA tensors only and raises on anything else; each launch adds one
to `LAUNCHES["downsample"]`.
"""

from __future__ import annotations

import torch

from dip_tpu_torch.ops import _build

LAUNCHES = {"downsample": 0}
SMEM_BUDGET = 48 * 1024  # static shared-memory limit; no opt-in needed


def reset_launches() -> None:
    LAUNCHES["downsample"] = 0


def tile_plan(ksize: int, factor: int, c: int) -> tuple[int, int, int]:
    """(tile, channels per block, shared bytes): the largest square tile of
    output pixels, up to 8x8, whose H-pass rows (tile rows of (tile-1)*f+K
    columns) and taps fit in SMEM_BUDGET with up to 4 channels a block,
    then with one. The same formula as the launcher in csrc/resample.cu."""
    for ct in (min(c, 4), 1):
        for tile in (8, 4, 2, 1):
            smem = 4 * (tile * ((tile - 1) * factor + ksize) * ct + ksize)
            if smem <= SMEM_BUDGET:
                return tile, ct, smem
    raise ValueError(f"a {ksize}-tap kernel at factor {factor} does not fit the "
                     f"downsample kernel's shared memory")


def downsample_fused(x: torch.Tensor, taps: torch.Tensor, factor: int, pad: int,
                     h_out: int, w_out: int) -> torch.Tensor:
    """x (N,H,W,C) f32 contiguous on a CUDA device, taps (K,) f32 on the
    same device -> (N, h_out, w_out, C) f32."""
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
    if (h + 2 * pad - ksize) // factor + 1 != h_out or (
            w + 2 * pad - ksize) // factor + 1 != w_out or h_out < 1 or w_out < 1:
        raise ValueError(f"bad downsample geometry: {tuple(x.shape)}, K={ksize}, "
                         f"f={factor}, p={pad} -> {h_out}x{w_out}")
    tile, ct, _ = tile_plan(ksize, factor, c)
    if n > 65535 or -(-c // ct) > 65535:
        raise ValueError(f"downsample grid too large for N={n}, C={c}")
    out = torch.empty((n, h_out, w_out, c), dtype=torch.float32, device=x.device)
    rc = _build.load().dip_downsample(
        x.data_ptr(), taps.data_ptr(), out.data_ptr(), n, h, w, c, h_out, w_out,
        factor, ksize, pad, tile, ct, _build.stream())
    _build.raise_on(rc, "downsample")
    LAUNCHES["downsample"] += 1
    return out
