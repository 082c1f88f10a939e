"""The kernel wrappers' launch counters, read and moved together.

Each wrapper adds one to its counter where it launches its kernel. A CUDA
graph's capture runs the wrappers' Python without launching anything, so
the fit engine takes back what a capture added and adds it again at every
replay (fit/engine.py), and the counters count launches for graphed fits
too.
"""

from __future__ import annotations

from dip_tpu_torch.ops import (hopper_moments, hopper_resample, hopper_s2d, hopper_up_conv,
                               hopper_wgrad)

_MODULES = (hopper_up_conv, hopper_resample, hopper_s2d, hopper_wgrad, hopper_moments)


def counts() -> dict[str, int]:
    """Every counter, by kernel."""
    return {k: v for mod in _MODULES for k, v in mod.LAUNCHES.items()}


def reset() -> None:
    """Set every counter to 0."""
    for mod in _MODULES:
        mod.reset_launches()


def add(delta: dict[str, int], times: int = 1) -> None:
    """Add `times` x delta[k] to counter k."""
    for mod in _MODULES:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] += times * delta.get(k, 0)
