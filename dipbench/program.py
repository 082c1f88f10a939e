"""The system under test: a configuration's fit, or its batch of fits, built
from the port (`dip_tpu_torch`) through its public entry points, fed the
benchmark's inputs, and driven the way a user's loop drives it: chunks of
`log_every` steps with a host read of the chunk's metric rows after each.

Traffic `engine` 'single' is one fit through `Engine` (`run_chunk`, then
`wait`, then the rows to the host, as `Engine.run` does with a callback);
'batch' is the fits as one `BatchEngine` program (`run`, whose history is
the rows on the host). This module and `harness.py` are the only ones
that import the port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dip_tpu_torch import models
from dip_tpu_torch.fit.engine import Engine, FitConfig
from dip_tpu_torch.parallel import BatchEngine

from dipbench import tasks
from dipbench.inputs import Inputs

# Adam's first moment after one step is (1 - beta1) * g (PyTorch's default beta1)
_ADAM_BETA1 = 0.9


class Program:
    """One cell's fits on `device`, their weights and inputs the benchmark's."""

    def __init__(self, cfg: dict, traffic: dict, inputs: Inputs, device: torch.device):
        fit, log_every = cfg["fit"], traffic["log_every"]
        fcfg = FitConfig(num_iter=log_every, lr=fit["lr"], optimizer=fit["optimizer"],
                         reg_noise_std=fit["reg_noise_std"], exp_weight=fit["exp_weight"],
                         log_every=log_every,
                         compute_dtype="bfloat16" if cfg["precision"] == "bfloat16" else None)
        # the port's net of the configuration's `program_net` name
        model = getattr(models, cfg["program_net"])(**cfg["net"])
        loss, metrics = tasks.load(cfg["task"]).program_fns()
        if traffic["engine"] == "single":
            if traffic["fits"] != 1:
                raise ValueError("the 'single' engine runs one fit")
            self.engine = Engine(model, loss, fcfg, metrics, device=device)
            self.aux = _first(inputs.aux)
            self.state = self.engine.init_state(inputs.fit_seeds[0], inputs.z[0])
            self.params = self.state.params
            self.opt = self.state.opt
        elif traffic["engine"] == "batch":
            self.engine = BatchEngine(model, loss, fcfg, metrics, device=device)
            self.aux = inputs.aux
            self.state = self.engine.init_state(inputs.fit_seeds, inputs.z)
            shard = self.state.shards[0]
            self.params, self.opt = shard.params, shard.opt
        else:
            raise ValueError(f"unknown engine {traffic['engine']!r}")
        if set(self.params) != set(inputs.weights):
            raise ValueError("the program's parameters are not the reference's: "
                             f"{sorted(set(self.params) ^ set(inputs.weights))}")
        with torch.no_grad():
            for k, p in self.params.items():
                w = inputs.weights[k]
                p.copy_(w[0] if traffic["engine"] == "single" else w)

    def run(self, n: int) -> dict[str, np.ndarray]:
        """n steps of every fit, then the rows on the host: each metric's
        (n, fits) array."""
        if isinstance(self.engine, BatchEngine):
            # BatchEngine.run takes cfg.num_iter steps in chunks of log_every
            self.engine.cfg = dataclasses.replace(self.engine.cfg, num_iter=n)
            return self.engine.run(self.state, self.aux)[1]
        rows = self.engine.run_chunk(self.state, self.aux, n)
        self.engine.wait()
        return {k: v.cpu().numpy().reshape(n, 1) for k, v in rows.items()}

    def _stacked(self, t: torch.Tensor) -> torch.Tensor:
        return t.unsqueeze(0) if isinstance(self.engine, Engine) else t

    def grad_norms(self) -> dict[str, np.ndarray]:
        """Each leaf's norm of the gradient the optimizer got at the first
        step, per fit (fits,), from Adam's first moment after that step
        (zero where the optimizer keeps no state for the leaf)."""
        out = {}
        for k, p in self.params.items():
            m = self.opt.state.get(p, {}).get("exp_avg")
            g = torch.zeros_like(p) if m is None else m / (1 - _ADAM_BETA1)
            out[k] = _norms(self._stacked(g))
        return out

    def change_norms(self, weights: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """Each leaf's norm of its change from `weights`, per fit (fits,)."""
        return {k: _norms(self._stacked(p.detach()) - weights[k].to(p.device))
                for k, p in self.params.items()}

    def output(self) -> torch.Tensor:
        """The fits' output EMA as the next step reads it, (fits, 1, H, W, C),
        on the host."""
        ema = (self.state.shards[0].ema_out if isinstance(self.engine, BatchEngine)
               else self.state.ema_out.unsqueeze(0))
        return ema.detach().to("cpu", copy=True)


def _first(aux):
    return {k: v[0] for k, v in aux.items()} if isinstance(aux, dict) else aux[0]


def _norms(t: torch.Tensor) -> np.ndarray:
    """Per-fit L2 norms of a stacked (fits, ...) tensor, in float64."""
    flat = t.detach().reshape(t.shape[0], -1).to(torch.float64)
    return torch.linalg.vector_norm(flat, dim=1).cpu().numpy()


def fit_iters(rows: dict[str, np.ndarray]) -> tuple[int, int]:
    """(fit-iterations, those whose loss is not finite) of a chunk's rows."""
    loss = rows["loss"]
    return int(math.prod(loss.shape)), int(np.sum(~np.isfinite(loss)))
