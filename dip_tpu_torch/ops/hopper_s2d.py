"""Packed space-to-depth (K4): its Hopper kernel, its plain version, and a
differentiable op.

Counterpart of dip_tpu/ops/pallas_s2d.py's `s2d_pack`:

    out[n, y, x, (p*2 + q)*C + c] = x[n, 2y + p, 2x + q, c]

(N, H, W, C) with H and W even -> (N, H/2, W/2, 4C), with an optional cast
fused into the same pass. The seam backward (ops/hopper_up_conv.py) runs it
on every HR cotangent dz, f32 or bf16 in and bf16 out: the phase-major dzq
its dgrad and wgrad kernels read.

The kernel lives in `csrc/s2d.cu`. It takes the input's four strides, so a
channel-planar dz (what the add after a decoder seam hands back) needs no
copy first; its output is contiguous. `s2d_pack` takes the plain version
only when the tensor lies on the CPU; on a CUDA tensor it launches the
kernel or raises. Each launch adds one to `LAUNCHES["s2d_pack"]`.
"""

from __future__ import annotations

import torch

from dip_tpu_torch.ops import _build

LAUNCHES = {"s2d_pack": 0}
_FLOATS = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    LAUNCHES["s2d_pack"] = 0


def _dims(x: torch.Tensor, out_dtype: torch.dtype | None) -> tuple[int, int, int, int, torch.dtype]:
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"(N, H, W, C) with H and W even expected, got {tuple(x.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.dtype not in _FLOATS or out_dtype not in _FLOATS:
        raise TypeError(f"s2d_pack takes and gives float32 or bfloat16, got "
                        f"{x.dtype} -> {out_dtype}")
    n, h, w, c = x.shape
    return n, h // 2, w // 2, c, out_dtype


def s2d_pack_plain(x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K4's plain version: cast, 6-D view, permute, contiguous copy."""
    n, h2, w2, c, out_dtype = _dims(x, out_dtype)
    y = x.to(out_dtype).reshape(n, h2, 2, w2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h2, w2, 4 * c).contiguous()


def s2d_pack(x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Packed space-to-depth of `x` in `out_dtype` (x's dtype if None):
    the plain version on a CPU tensor, the kernel on a CUDA tensor."""
    n, h2, w2, c, out_dtype = _dims(x, out_dtype)
    if _build.on_cpu(x=x):
        return s2d_pack_plain(x, out_dtype)
    out = torch.empty((n, h2, w2, 4 * c), dtype=out_dtype, device=x.device)
    if out.numel():
        rc = _build.load().dip_s2d_pack(
            x.data_ptr(), out.data_ptr(), n, h2, w2, c, *x.stride(),
            int(x.dtype == torch.float32), int(out_dtype == torch.float32), _build.stream())
        _build.raise_on(rc, "s2d_pack")
        LAUNCHES["s2d_pack"] += 1
    return out


class S2DPack(torch.autograd.Function):
    """s2d_pack with its exact inverse permutation as the backward (plain
    PyTorch, as the JAX package leaves that backward to XLA), returned in
    the input's dtype. Under torch.func.vmap the fits fold into N: one
    launch for all of them."""

    @staticmethod
    def forward(x: torch.Tensor, out_dtype: torch.dtype | None) -> torch.Tensor:
        return s2d_pack(x, out_dtype)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        x, _ = inputs
        ctx.shape, ctx.dtype = tuple(x.shape), x.dtype

    @staticmethod
    def vmap(info, in_dims, x, out_dtype):
        x = x.movedim(in_dims[0], 0)
        out = S2DPack.apply(x.reshape(-1, *x.shape[2:]), out_dtype)
        return out.reshape(x.shape[0], -1, *out.shape[1:]), 0

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        n, h, w, c = ctx.shape
        dx = g.reshape(n, h // 2, w // 2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return dx.reshape(n, h, w, c).to(ctx.dtype), None


def s2d(x: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Differentiable packed space-to-depth."""
    return S2DPack.apply(x, out_dtype)
