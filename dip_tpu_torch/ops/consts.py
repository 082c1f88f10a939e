"""Host-built constants, copied to the device once."""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def device_const(make: Callable[..., np.ndarray], arg, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """make(arg) as a tensor on `device`, built once per (make, arg, dtype,
    device): a fresh host-to-device copy every step would make the host
    wait for the device."""
    return torch.as_tensor(make(arg), dtype=dtype, device=device)
