"""Spatial padding for NHWC (or HWC) tensors: zero, reflection, replication.

Counterpart of dip_tpu/ops/pad.py on `F.pad`, whose own backward folds the
padded strips back (the JAX package needed a hand-written VJP for that).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_MODES = {
    "zero": "constant",
    "constant": "constant",
    "reflection": "reflect",
    "reflect": "reflect",
    "replication": "replicate",
    "replicate": "replicate",
    "edge": "replicate",
}


def pad2d(x: torch.Tensor, pad: int | tuple[int, int],
          mode: str = "zero") -> torch.Tensor:
    """Pad the spatial dims (H, W) of an NHWC or HWC tensor."""
    ph, pw = (pad, pad) if isinstance(pad, int) else pad
    if ph == 0 and pw == 0:
        return x
    if mode not in _MODES:
        raise ValueError(f"unknown pad mode {mode!r}")
    x4 = x if x.dim() == 4 else x.unsqueeze(0)
    y = F.pad(x4.permute(0, 3, 1, 2), (pw, pw, ph, ph), mode=_MODES[mode])
    y = y.permute(0, 2, 3, 1)
    return y if x.dim() == 4 else y.squeeze(0)
