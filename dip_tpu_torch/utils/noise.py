"""Network-input generators (the `z` code tensor), NHWC (1, H, W, C).

Counterpart of dip_tpu/utils/noise.py with an explicit torch.Generator in
place of a jax.random key. The two give different numbers from one seed.
"""

from __future__ import annotations

import numpy as np
import torch


def get_noise(generator: torch.Generator | None, input_depth: int, method: str,
              spatial_size: int | tuple[int, int], noise_type: str = "u",
              var: float = 0.1, *, device: torch.device | str) -> torch.Tensor:
    """method 'noise': U(0,1) ('u') or N(0,1) ('n') times `var`, drawn on
    the generator's device and moved to `device`; method 'meshgrid': the
    2-channel normalised X/Y grid (input_depth must be 2)."""
    h, w = (spatial_size, spatial_size) if isinstance(spatial_size, int) else spatial_size
    if method == "noise":
        if generator is None:
            raise ValueError("method 'noise' needs a torch.Generator")
        shape = (1, h, w, input_depth)
        if noise_type == "u":
            z = torch.rand(shape, generator=generator, device=generator.device)
        elif noise_type == "n":
            z = torch.randn(shape, generator=generator, device=generator.device)
        else:
            raise ValueError(f"unknown noise_type {noise_type!r}")
        return (z * var).to(device)
    if method == "meshgrid":
        if input_depth != 2:
            raise ValueError("meshgrid input requires input_depth == 2")
        xg, yg = np.meshgrid(np.arange(w) / float(w - 1), np.arange(h) / float(h - 1))
        grid = np.stack([xg, yg], axis=-1).astype(np.float32)
        return torch.from_numpy(grid[None]).to(device)
    raise ValueError(f"unknown method {method!r}")
