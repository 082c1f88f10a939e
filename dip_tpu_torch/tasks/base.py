"""Uniform task protocol (counterpart of dip_tpu/tasks/base.py).

A TaskSpec bundles the generator, the fit config, the loss over the
degraded observation and the metrics; run_task makes the input z (or
takes the spec's own), fits, renders and post-processes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from dip_tpu_torch.fit.engine import Engine, FitConfig, FitState
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
    net_input: Any = None                      # explicit z (flash/no-flash)
    extra_params: dict[str, torch.Tensor] | None = None  # e.g. {'down': K x K}
    postprocess: Callable[[torch.Tensor], Any] | None = None  # applied to the render


def to_device(aux: Any, device: torch.device) -> Any:
    """Move a tensor, or the tensors of a dict, to `device`."""
    if isinstance(aux, dict):
        return {k: to_device(v, device) for k, v in aux.items()}
    return aux.to(device) if isinstance(aux, torch.Tensor) else aux


def make_input(spec: TaskSpec, generator: torch.Generator,
               device: torch.device | str) -> torch.Tensor:
    """z on `device`: spec.net_input when given, else noise from
    `generator` of spec.spatial_size."""
    if spec.net_input is not None:
        return torch.as_tensor(spec.net_input, dtype=torch.float32).to(device)
    if spec.spatial_size is None:
        raise ValueError("spatial_size or net_input required")
    return get_noise(generator, spec.input_depth, spec.input_method,
                     spec.spatial_size, var=spec.input_var, device=device)


def start_task(spec: TaskSpec, seed: int, *, device: torch.device | str):
    """(engine, state, aux) of a fit of `spec` on `device`, ready to run:
    z from a CPU generator seeded with `seed`, the weights from seed+1, the
    input jitter from seed+2 and the weight jitter from seed+3, so z and
    the initial weights do not depend on the device."""
    eng = Engine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn, device=device)
    z = make_input(spec, torch.Generator().manual_seed(seed), eng.device)
    aux = to_device(spec.aux, eng.device)
    return eng, eng.init_state(seed + 1, z, spec.extra_params), aux


def finish_task(spec: TaskSpec, eng: Engine, state: FitState) -> Any:
    """The render of a finished fit, through spec.postprocess if given."""
    out = eng.render(state)
    return out if spec.postprocess is None else spec.postprocess(out)


def run_task(spec: TaskSpec, seed: int, *, device: torch.device | str, callback=None):
    """Fit the task on `device` (seeded as start_task says) and return
    (output image NHWC after spec.postprocess, state, history)."""
    eng, state, aux = start_task(spec, seed, device=device)
    state, history = eng.run(state, aux, callback)
    return finish_task(spec, eng, state), state, history
