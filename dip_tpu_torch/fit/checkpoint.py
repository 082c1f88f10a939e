"""Checkpoint and resume of a fit (counterpart of dip_tpu/fit/checkpoint.py).

The whole FitState goes to one `torch.save` file: the trainable leaves,
the optimizer's state_dict, z, the EMA, both jitter generators' states,
the backtracking snapshot, the tracked PSNR and the step on the host and
on the device. So a resumed fit takes the same steps as one that was not
interrupted: bit for bit on the CPU, and on the card wherever its kernels
are deterministic.
"""

from __future__ import annotations

import os

import torch

from dip_tpu_torch.fit.engine import FitState


def _host(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.detach().cpu()


def save_fit_state(path: str, state: FitState) -> None:
    """Write `state` to `path`. Overwrite-safe: the file is written beside
    `path` and then moved over it, so a save that is cut leaves the last
    checkpoint whole. On CUDA, call it where the fit's stream has been
    waited for (after Engine.run, or Engine.wait)."""
    blob = {
        "params": {k: _host(p) for k, p in state.params.items()},
        "opt": state.opt.state_dict(),
        "z": _host(state.z),
        "ema_out": _host(state.ema_out),
        "generator": state.generator.get_state(),
        "param_generator": (None if state.param_generator is None
                            else state.param_generator.get_state()),
        "snapshot": {k: _host(p) for k, p in state.snapshot.items()},
        "last_track": _host(state.last_track),
        "step": state.step,
        "device_step": _host(state.device_step),
    }
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def _check_like(name: str, got: dict, want: dict) -> None:
    if set(got) != set(want):
        raise ValueError(f"checkpoint {name} has leaves {sorted(got)}, the template "
                         f"{sorted(want)}")
    for k, t in want.items():
        if tuple(got[k].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {name}[{k!r}] has shape {tuple(got[k].shape)}, "
                             f"the template {tuple(t.shape)}")


def restore_fit_state(path: str, template: FitState) -> FitState:
    """Load `path` into `template` (an init_state result of an engine with
    the same model, config and device) and return it. The params, the
    snapshot, z, the tracked PSNR and the device step are copied in place
    (the net's params are the engine's model's own); the optimizer's state
    and the EMA are replaced, so the state's captured graph, which read
    the old ones, is dropped and the next run captures anew. Raises
    ValueError if a leaf's name or shape differs from the template's."""
    blob = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    _check_like("params", blob["params"], template.params)
    _check_like("snapshot", blob["snapshot"], template.snapshot)
    _check_like("z", {"z": blob["z"]}, {"z": template.z})
    if (blob["param_generator"] is None) != (template.param_generator is None):
        raise ValueError("checkpoint and template differ in weight jitter (param_noise)")
    if template.graph is not None:
        # its replays may still run: let them end before its pool goes
        torch.cuda.synchronize(template.z.device)
        template.graph = None
    with torch.no_grad():
        for k, p in template.params.items():
            p.copy_(blob["params"][k])
        for k, p in template.snapshot.items():
            p.copy_(blob["snapshot"][k])
        template.z.copy_(blob["z"])
        template.last_track.copy_(blob["last_track"])
        template.device_step.copy_(blob["device_step"])
    template.opt.load_state_dict(blob["opt"])
    ema = blob["ema_out"]
    template.ema_out = None if ema is None else ema.to(template.z.device)
    template.generator.set_state(blob["generator"])
    if template.param_generator is not None:
        template.param_generator.set_state(blob["param_generator"])
    template.step = blob["step"]
    return template
