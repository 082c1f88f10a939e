"""Uniform task protocol (counterpart of dip_tpu/tasks/base.py).

A TaskSpec bundles the generator, the fit config, the loss over the
degraded observation and the metrics; run_task makes the input z, fits,
and renders.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from dip_tpu_torch.fit.engine import Engine, FitConfig
from dip_tpu_torch.utils.noise import get_noise


@dataclasses.dataclass
class TaskSpec:
    name: str
    model: torch.nn.Module
    cfg: FitConfig
    loss_fn: Callable
    aux: Any                                   # tensors, moved to the device
    metrics_fn: Callable | None = None
    input_depth: int = 32
    input_method: str = "noise"
    input_var: float = 0.1
    spatial_size: tuple[int, int] | None = None
    extra_params: dict[str, torch.Tensor] | None = None  # e.g. {'down': K x K}


def to_device(aux: Any, device: torch.device) -> Any:
    """Move a tensor, or the tensors of a dict, to `device`."""
    if isinstance(aux, dict):
        return {k: to_device(v, device) for k, v in aux.items()}
    return aux.to(device) if isinstance(aux, torch.Tensor) else aux


def make_input(spec: TaskSpec, generator: torch.Generator,
               device: torch.device | str) -> torch.Tensor:
    if spec.spatial_size is None:
        raise ValueError("spatial_size required")
    return get_noise(generator, spec.input_depth, spec.input_method,
                     spec.spatial_size, var=spec.input_var, device=device)


def run_task(spec: TaskSpec, seed: int, *, device: torch.device | str, callback=None):
    """Fit the task on `device` and return (output image NHWC, state, history).
    z comes from a CPU generator seeded with `seed`, the weights from seed+1,
    the input jitter from seed+2 and the weight jitter from seed+3, so z and
    the initial weights do not depend on the device."""
    eng = Engine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn, device=device)
    z = make_input(spec, torch.Generator().manual_seed(seed), eng.device)
    aux = to_device(spec.aux, eng.device)
    state = eng.init_state(seed + 1, z, spec.extra_params)
    state, history = eng.run(state, aux, callback)
    return eng.render(state), state, history
