"""Batched multi-image fitting: many independent fits as one program
(counterpart of dip_tpu/parallel/batch.py).

B fits of the same shape run as ONE step program on a device: every
trainable leaf is stacked (B, ...), the forward is
`vmap(functional_call(model, p_i, (z_i,)))` and the loss is the sum of the
per-fit losses, whose one backward gives each fit its own gradient (the
fits share no parameter). Under vmap, each decoder seam launches K1, K2,
K3 and K4 once for all B fits (ops/hopper_up_conv.py's fit axis), the
downsample, the pad and the s2d pack fold the fits into N, and the other
convolutions become grouped cuDNN convolutions. On a CUDA device the step
is captured in one CUDA graph for the batch and replayed on the batch's
own stream, as fit/engine.py does for one fit.

What stays per fit is what Engine does for one: the weights (fit i's are
`Engine.init_state(seeds[i], ...)`'s), the optimizer's arithmetic (Adam
and SGD are elementwise over the stacked leaves; L-BFGS is
fit/lbfgs.BatchZoomLBFGS, each fit's memory, direction and line search
its own), the input jitter (one generator per fit, seeded seeds[i] + 1)
and the weight jitter (seeds[i] + 2, std(w) taken per fit), the EMA,
backtracking's drop and restore, and the metrics. With conv_wgrad on, the
weight gradients of the stride-1 3x3 and 1x1 convs come from K5/K6 with
their fit axis (ops/hopper_wgrad.py's vmap rules).

L-BFGS runs as Engine runs it: at the fits' start `lbfgs_warmup` graphed
Adam steps, then eager L-BFGS steps, each a lockstep round of the B line
searches a trial, one host read a round. (The JAX BatchEngine gives its
L-BFGS fits no warm-up; fit i here is Engine with seed i, which has one.)

With a `mesh`, the batch is cut into one contiguous sub-batch per device,
each with its own model copy, graph and stream; `run` enqueues every
device's chunk before it waits on any (as shard_map runs its shards), and
there is no collective. The batch must divide by the mesh size.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.func import functional_call, vmap

from dip_tpu_torch.fit.engine import Engine, FitConfig, schedule_std
from dip_tpu_torch.fit.lbfgs import BatchZoomLBFGS
from dip_tpu_torch.parallel.mesh import Mesh, shard_batch
from dip_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class BatchFitState:
    """The state of one device's b fits; the step updates it in place.
    Every tensor leaf has the fits on its leading axis."""

    params: dict[str, torch.Tensor]    # trainable f32 leaves, stacked (b, ...)
    opt: torch.optim.Optimizer
    z: torch.Tensor                    # (b, 1, H, W, C), the initial inputs
    ema_out: torch.Tensor | None       # (b, 1, H, W, C), None until the first step
    generators: list[torch.Generator]  # input jitter, one per fit
    snapshot: dict[str, torch.Tensor]  # params for backtracking ({} if off)
    last_track: torch.Tensor           # (b,) tracked PSNR at each fit's last good step
    step: int                          # steps taken, on the host
    device_step: torch.Tensor          # the same count on the device (int64)
    param_generators: list[torch.Generator] | None = None  # weight jitter
    graph: Any = None                  # the batch's captured step (CUDA)


@dataclasses.dataclass
class BatchState:
    """A BatchEngine's state: one BatchFitState per device of its mesh
    (one without a mesh), fits in order."""

    shards: list[BatchFitState]

    @property
    def step(self) -> int:
        return self.shards[0].step

    def leaf(self, name: str) -> torch.Tensor:
        """Trainable leaf `name` of every fit, (B, ...), on the CPU."""
        return torch.cat([s.params[name].detach().cpu() for s in self.shards])


class _DeviceBatch(Engine):
    """b fits on one device as one vmapped step program: Engine's step
    body (its hooks vmapped here), capture, replays and stream, over a
    BatchFitState."""

    def init_state(self, seeds: Sequence[int], zs: torch.Tensor,
                   extra: dict[str, torch.Tensor] | None = None) -> BatchFitState:
        per_fit = []
        for seed in seeds:
            self.model.reset_parameters(torch.Generator().manual_seed(int(seed)))
            per_fit.append({k: p.detach().clone() for k, p in self.model.named_parameters()})
        params = {k: torch.stack([p[k] for p in per_fit]) for k in self.net_keys}
        zs = zs.to(self.device, torch.float32)
        leaves = dict(extra or {})
        if self.cfg.opt_input:
            leaves["input"] = zs
        for k, v in leaves.items():
            if k in params:
                raise ValueError(f"trainable leaf {k!r} clashes with a parameter name")
            if v.shape[0] != len(seeds):
                raise ValueError(f"extra leaf {k!r} has {v.shape[0]} fits, not {len(seeds)}")
            params[k] = torch.as_tensor(v).detach().to(self.device, torch.float32).clone()
        params = {k: v.to(self.device).requires_grad_() for k, v in params.items()}
        gens = [torch.Generator(device=self.device).manual_seed(int(s) + 1) for s in seeds]
        pgens = ([torch.Generator(device=self.device).manual_seed(int(s) + 2) for s in seeds]
                 if self.cfg.param_noise else None)
        snapshot = ({k: p.detach().clone() for k, p in params.items()}
                    if self.cfg.backtrack else {})
        return BatchFitState(
            params=params, opt=self._optimizer(params), z=zs, ema_out=None, generators=gens,
            snapshot=snapshot, last_track=torch.zeros(len(seeds), device=self.device), step=0,
            device_step=torch.zeros((), dtype=torch.int64, device=self.device),
            param_generators=pgens)

    def _generators(self, state: BatchFitState) -> list[torch.Generator]:
        return state.generators + (state.param_generators or [])

    def _jitter(self, state: BatchFitState) -> torch.Tensor | None:
        """Each fit's input jitter, std * N(0,1) from its own generator."""
        cfg = self.cfg
        if self._schedule is not None:
            std = schedule_std(state.device_step, *self._schedule)
        elif cfg.reg_noise_std > 0:
            std = cfg.reg_noise_std
        else:
            return None
        shape = state.z.shape[1:]
        with span("dip.batch.jitter"):
            return std * torch.stack([
                torch.randn(shape, generator=g, device=self.device, dtype=state.z.dtype)
                for g in state.generators])

    def _optimizer(self, params: dict[str, torch.Tensor]) -> torch.optim.Optimizer:
        if self.cfg.optimizer == "lbfgs":
            return BatchZoomLBFGS(params.values())
        return super()._optimizer(params)

    def _weight_noise(self, state: BatchFitState) -> dict[str, torch.Tensor]:
        """Each fit's N(0,1) of each conv weight's shape, by name, from the
        fit's own weight-jitter generator, stacked (b, ...)."""
        with span("dip.batch.jitter"):
            return {k: torch.stack([torch.randn(w.shape[1:], generator=g, device=w.device,
                                                dtype=w.dtype) for g in state.param_generators])
                    for k, w in ((k, state.params[k]) for k in self.net_keys) if w.dim() == 5}

    def net_params(self, state: BatchFitState, train: bool,
                   noise: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """The net's stacked parameters as the forward sees them: with
        param_noise and `train`, each fit's conv weight plus its N(0,1)
        (from `noise`, _weight_noise's draws, else a fresh draw) times that
        fit's std(w) / 50 (ddof 0)."""
        net = {k: state.params[k] for k in self.net_keys}
        if not (train and self.cfg.param_noise):
            return net
        for k, eps in (self._weight_noise(state) if noise is None else noise).items():
            w = net[k]
            std = torch.std(w, dim=(1, 2, 3, 4), correction=0, keepdim=True)
            net[k] = w + eps * (std / 50.0)
        return net

    def _forward(self, net: dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
        """vmap of the model over the fits: (b, 1, H, W, C) in and out."""
        fits = vmap(lambda p, zi: functional_call(self.model, p, (zi,)))
        if self.cfg.compute_dtype is None:
            return fits(net, z)
        with span("dip.fit.cast"):
            cast = {k: v.to(torch.bfloat16) for k, v in net.items()}
            zc = z.to(torch.bfloat16)
        out = fits(cast, zc)
        with span("dip.fit.cast"):
            return out.to(torch.float32)

    def _loss(self, params: dict[str, torch.Tensor], out: torch.Tensor,
              aux: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """The per-fit losses: their sum's one backward gives each fit its
        own gradient; the optimizer gets the (b,) losses."""
        losses = vmap(self.loss_fn)(params, out, aux)
        return losses.sum(), losses.detach()

    def _step_metrics(self, out: torch.Tensor, ema: torch.Tensor, aux: Any) -> dict:
        return vmap(self.metrics_fn)(out, ema, aux)

    def on_device(self):
        """The device context the fits' eager launches need (the kernels
        launch on the current device's current stream)."""
        return (torch.cuda.device(self.device) if self._stream is not None
                else contextlib.nullcontext())


class BatchEngine:
    """B independent fits of one shape as one program (per device).

    Args:
        model: an nn.Module mapping z (1,H,W,Cin) -> image (1,H,W,Cout); its
            parameters name the stacked leaves (the module's own are not
            trained).
        loss_fn: (params, out, aux) -> 0-d loss, for ONE fit (vmapped over
            the fits: params, out and aux are one fit's).
        cfg: FitConfig.
        metrics_fn: optional (out, ema_out, aux) -> dict of 0-d tensors, for
            one fit; with backtracking it must give 'psnr_track'.
        mesh: a parallel.mesh.Mesh; the batch is cut into one sub-batch per
            device. Without one, `device` ('cuda' or 'cpu') holds them all.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, cfg: FitConfig,
                 metrics_fn: Callable | None = None, mesh: Mesh | None = None, *,
                 device: torch.device | str | None = None):
        if (mesh is None) == (device is None):
            raise ValueError("give BatchEngine a mesh or a device, not both")
        if "input" in cfg.opt_over.split(",") and not cfg.opt_input:
            cfg = dataclasses.replace(cfg, opt_input=True)
        self.cfg = cfg
        self.mesh = mesh
        devices = mesh.devices if mesh is not None else (torch.device(device),)
        self.parts = [_DeviceBatch(model if i == 0 else copy.deepcopy(model), loss_fn, cfg,
                                   metrics_fn, device=d) for i, d in enumerate(devices)]
        self._auxs = None

    def init_state(self, seeds: Sequence[int], zs: torch.Tensor,
                   extra_params: dict[str, torch.Tensor] | None = None) -> BatchState:
        """Fit i: the weights Engine.init_state(seeds[i], zs[i]) draws, its
        jitter streams from seeds[i] + 1 and + 2. zs: (B, 1, H, W, C).
        `extra_params`: further trainable leaves by name, each (B, ...),
        one initial value per fit."""
        seeds = [int(s) for s in seeds]
        if zs.shape[0] != len(seeds):
            raise ValueError(f"{len(seeds)} seeds for {zs.shape[0]} inputs")
        n = len(self.parts)
        if len(seeds) % n:
            raise ValueError(f"batch {len(seeds)} must divide by mesh size {n}")
        per = len(seeds) // n
        zs_parts = [zs[k * per:(k + 1) * per] for k in range(n)]
        extras = ([None] * n if extra_params is None else
                  [{k: v[i * per:(i + 1) * per] for k, v in extra_params.items()}
                   for i in range(n)])
        return BatchState([p.init_state(seeds[k * per:(k + 1) * per], zs_parts[k], extras[k])
                           for k, p in enumerate(self.parts)])

    def _split(self, auxs: Any) -> list[Any]:
        """`auxs` (leaves (B, ...)) cut per device, the same objects on each
        run with the same auxs, so that the graphs captured for them stay."""
        if self._auxs is None or self._auxs[0] is not auxs:
            mesh = self.mesh or Mesh([self.parts[0].device])
            self._auxs = (auxs, shard_batch(auxs, mesh))
        return self._auxs[1]

    def step(self, state: BatchState, auxs: Any) -> dict[str, torch.Tensor]:
        """One eager step of every fit; each metric (B,), on the first
        device."""
        dev = self.parts[0].device
        ms = []
        for p, s, a in zip(self.parts, state.shards, self._split(auxs)):
            with p.on_device():
                ms.append(p.step(s, a)[1])
        return {k: torch.cat([m[k].to(dev) for m in ms]) for k in ms[0]}

    def run(self, state: BatchState, auxs: Any,
            callback: Callable[[int, dict, BatchState], None] | None = None):
        """cfg.num_iter steps in chunks of log_every: every device's chunk
        is enqueued before any is waited for; the host syncs at a chunk's
        end only with `callback` (given each metric's (n, B) numpy array).
        Returns (state, history: each metric's (num_iter, B) numpy array)."""
        parts_aux = self._split(auxs)
        if self.cfg.optimizer != "lbfgs":  # L-BFGS steps are eager (Engine.run_chunk)
            for p, s, a in zip(self.parts, state.shards, parts_aux):
                p.capture(s, a)  # a capture waits for its device: all before any chunk
        remaining, it = self.cfg.num_iter, 0
        chunks: list[list[dict]] = []
        while remaining > 0:
            n = min(self.cfg.log_every, remaining)
            with span("dip.batch.chunk"):
                chunks.append([p.run_chunk(s, a, n)
                               for p, s, a in zip(self.parts, state.shards, parts_aux)])
                for p in self.parts:
                    p.wait()
            remaining -= n
            it += n
            if callback is not None:
                callback(it, _host(chunks[-1]), state)
        history = [_host(c) for c in chunks]
        return state, {k: np.concatenate([h[k] for h in history]) for k in history[0]}

    def render(self, state: BatchState) -> torch.Tensor:
        """Every fit's final forward with its un-jittered input, (B, 1, H,
        W, C), on the first device."""
        dev = self.parts[0].device
        outs = []
        for p, s in zip(self.parts, state.shards):
            with p.on_device():
                outs.append(p.render(s).to(dev))
        return torch.cat(outs)


def _host(per_device: list[dict]) -> dict[str, np.ndarray]:
    """Per-device (n, b) metrics as one (n, B) numpy array each."""
    with span("dip.batch.host"):
        return {k: np.concatenate([np.asarray(m[k].cpu()) for m in per_device], axis=1)
                for k in per_device[0]}
