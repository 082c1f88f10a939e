"""The DIP fit loop: jitter, forward, loss, backward, optimizer, EMA,
metrics and PSNR backtracking, on one device.

Counterpart of dip_tpu/fit/engine.py, which scans the same step body on
the device as one jitted program a chunk. Here the counterpart of that
program is a CUDA graph: on a CUDA device, `Engine.run` (and
`run_chunk`) captures one training step per fit and replays it, so the
host meets the device only at a `log_every` chunk's edge. The step before
the capture is a real step of the fit (the EMA's initialisation, the
optimizer's state, cuDNN's plans, the kernel library, the seam's device
constants and the split plans come from it), and each later step of the
fit is a replay on the fit's own stream. On the CPU, `run` takes its
steps eagerly. `Engine.step` is the eager body both start from: every
piece of state the graph touches (the params, the optimizer's moments,
the EMA, the backtracking snapshot, the tracked PSNR, the step counter on
the device) is updated in place, the jitter schedule and the EMA's first
step are chosen on the device from that counter, and metrics stay 0-d
device tensors, so the step holds no host sync and no Python branch on
the step number. L-BFGS is the exception: its line search reads each
trial's Wolfe test on the host, so its steps run eagerly on every device
(`capture` raises for it); its Adam warm-up is graphed as any Adam fit.

Semantics (as the JAX engine):
 - input jitter: z_used = z + N(0,1) * std each step, std from
   `reg_noise_schedule` (the first (until_step, std) with step < until_step,
   else `reg_noise_std`: jnp.select's first match) or `reg_noise_std`;
 - weight jitter (param_noise): before each training forward, every 4-D
   net parameter (the conv weights) gets N(0,1) * std(w) / 50, drawn from
   a generator of its own and added in f32 before any bf16 cast; the
   gradient flows through std(w) as in the JAX package. The render and
   the master weights get no noise;
 - EMA output smoothing, initialised to the first output;
 - backtracking: if the tracked PSNR drops more than
   `backtrack_threshold` dB below the last good value, restore the
   snapshot (the params before the last good update) and skip this
   update; otherwise the snapshot becomes the params before this update.
   The optimizer's moments are not restored.
 - optimizer: 'adam' (capturable on CUDA, so the eager and the replayed
   step run the same arithmetic) or 'sgd' (plain SGD, optax.sgd's
   defaults) or 'lbfgs' (fit/lbfgs.py, optax.lbfgs with its zoom line
   search): at the fit's start, `lbfgs_warmup` Adam steps at
   `lbfgs_warmup_lr` without backtracking, then a fresh L-BFGS state and
   `num_iter` L-BFGS steps. Each L-BFGS step draws its input jitter and
   weight jitter once, and every evaluation of its line search runs the
   forward with those draws. The metrics are those of the step's first
   evaluation (the params before the update), plus 'evals', the step's
   value-and-gradient evaluations.
 - compute_dtype='bfloat16': the net's params and z are cast each step
   (master params stay f32, the output goes back to f32 before the loss);
   no autocast. Extra trainable leaves stay f32.
 - optimize-over: the trainable set is the net's parameters, plus the
   input z ('input' in opt_over, or opt_input), plus each extra leaf
   (e.g. 'down', a learnable degradation kernel). All of them go to the
   optimizer and to the backtracking snapshot; loss_fn sees them by name.
   With a trainable z the jitter is drawn around its current value.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from dip_tpu_torch.fit.lbfgs import ZoomLBFGS
from dip_tpu_torch.ops import launches
from dip_tpu_torch.ops.losses import psnr
from dip_tpu_torch.utils.profiling import span

OPTIMIZERS = ("adam", "sgd", "lbfgs")


@dataclasses.dataclass(frozen=True)
class FitConfig:
    num_iter: int = 3000
    lr: float = 0.01
    optimizer: str = "adam"           # 'adam' | 'sgd' | 'lbfgs'
    reg_noise_std: float = 0.0        # input jitter std
    param_noise: bool = False         # conv-weight jitter
    exp_weight: float | None = None   # EMA factor, e.g. 0.99
    backtrack: bool = False
    backtrack_threshold: float = 5.0
    log_every: int = 100              # steps between host syncs
    lbfgs_warmup: int = 100           # Adam steps before L-BFGS
    lbfgs_warmup_lr: float = 1e-3
    compute_dtype: str | None = None  # 'bfloat16' for mixed precision
    opt_input: bool = False           # optimise z as well
    opt_over: str = "net"             # 'net,input,down'; 'input' sets opt_input
    # staged jitter: ((until_step, std), ...); the first pair with
    # step < until_step gives the std, past the last one reg_noise_std does
    # (feature_inversion.ipynb's recipe). Chosen on the device each step.
    reg_noise_schedule: tuple[tuple[int, float], ...] | None = None


@dataclasses.dataclass
class FitState:
    """Mutable fit state; Engine.step updates it in place."""

    params: dict[str, torch.Tensor]    # trainable f32 leaves: the model's
                                       # parameters by name, 'input', extras
    opt: torch.optim.Optimizer
    z: torch.Tensor                    # saved base input (the initial z)
    ema_out: torch.Tensor | None       # None until the first step
    generator: torch.Generator         # input jitter, on the fit's device
    snapshot: dict[str, torch.Tensor]  # params for backtracking ({} if off)
    last_track: torch.Tensor           # tracked PSNR at the last good step
    step: int                          # steps taken, on the host
    device_step: torch.Tensor          # the same count on the device (int64)
    param_generator: torch.Generator | None = None  # weight jitter (param_noise)
    graph: Any = None                  # this state's captured step (CUDA)


@dataclasses.dataclass
class _Graph:
    """One training step of one FitState captured in a CUDA graph, with
    the static buffers its replays write: `table` row i holds the metrics
    of a chunk's step i, `slot` the next row."""

    graph: Any               # torch.cuda.CUDAGraph
    aux: Any                 # replays read the tensors aux held at capture
    keys: tuple[str, ...]    # the metrics, in table column order
    table: torch.Tensor      # (log_every, len(keys)) f32
    slot: torch.Tensor       # (1,) int64
    launches: dict[str, int]  # kernel launches of one replay, by counter
    pending: int = 1         # rows of the next chunk already written


def resolve_device(device: torch.device | str) -> torch.device:
    """The fit's device; raises if it is a CUDA device and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def disable_tf32() -> dict:
    """Turn both TF32 switches off explicitly (f32 convs and matmuls run in
    full f32; cuDNN's default is TF32) and return them, for printing beside
    every timing."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return tf32_flags()


def tf32_flags() -> dict:
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def schedule_std(step: torch.Tensor, bounds: torch.Tensor, stds: torch.Tensor,
                 default: torch.Tensor) -> torch.Tensor:
    """The jitter std at `step` (0-d): stds[i] of the first i with
    step < bounds[i], else `default` (jnp.select's first match), chosen on
    the device."""
    std = default
    for i in reversed(range(bounds.shape[0])):
        std = torch.where(step < bounds[i], stds[i], std)
    return std


def _write_row(metrics: dict, keys: tuple[str, ...], table: torch.Tensor,
               slot: torch.Tensor) -> None:
    """metrics[keys] into row `slot` of `table`, then slot + 1 (on the
    device: no host sync)."""
    with span("dip.fit.row"):
        row = torch.stack([metrics[k].to(torch.float32) for k in keys])
        table.index_copy_(0, slot, row[None])
        slot.add_(1)


def concat_history(chunks: list[dict]) -> dict[str, np.ndarray]:
    """Per-chunk metrics (device tensors or numpy arrays) as one numpy
    array per metric."""
    return {k: np.concatenate([np.asarray(c[k].cpu()) if isinstance(c[k], torch.Tensor)
                               else c[k] for c in chunks]) for k in chunks[0]}


class Engine:
    """Per-image DIP fit.

    Args:
        model: an nn.Module mapping z (1,H,W,Cin) -> image (1,H,W,Cout),
            moved to `device` here; init_state resets its parameters and
            the fit trains them in place.
        loss_fn: (params, out, aux) -> 0-d loss tensor; params holds every
            trainable leaf by name (extra leaves as given to init_state).
        cfg: FitConfig.
        metrics_fn: optional (out, ema_out, aux) -> dict of 0-d tensors; with
            backtracking it must give 'psnr_track' (PSNR vs the fit target).
        device: where the fit runs ('cuda' or 'cpu'); no default.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, cfg: FitConfig,
                 metrics_fn: Callable | None = None, *, device: torch.device | str):
        if cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}; one of {OPTIMIZERS}")
        if cfg.compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}")
        if "input" in cfg.opt_over.split(",") and not cfg.opt_input:
            cfg = dataclasses.replace(cfg, opt_input=True)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.net_keys = tuple(k for k, _ in self.model.named_parameters())
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.metrics_fn = metrics_fn
        self.tf32 = disable_tf32()
        self._schedule = None
        if cfg.reg_noise_schedule:
            bounds, stds = zip(*cfg.reg_noise_schedule)
            self._schedule = (
                torch.tensor(bounds, dtype=torch.int64, device=self.device),
                torch.tensor(stds, dtype=torch.float32, device=self.device),
                torch.tensor(cfg.reg_noise_std, dtype=torch.float32, device=self.device))
        # the fit's own stream: its replays run there, so the host can
        # enqueue another fit's chunk while this one runs
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def init_state(self, seed: int, z: torch.Tensor,
                   extra_params: dict[str, torch.Tensor] | None = None) -> FitState:
        """Initialise the weights from `seed` (on a CPU generator, so every
        device gets the same weights), the trainable set, the optimizer and
        the jitter streams: input jitter from seed + 1, weight jitter from
        seed + 2, each on its own device generator. `extra_params` are
        further trainable leaves, by name, with their initial values."""
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        params = dict(self.model.named_parameters())
        z = z.to(self.device)
        leaves = dict(extra_params or {})
        if self.cfg.opt_input:
            leaves["input"] = z
        for k, v in leaves.items():
            if k in params:
                raise ValueError(f"trainable leaf {k!r} clashes with a parameter name")
            params[k] = v.detach().to(self.device, torch.float32).clone().requires_grad_()
        opt = self._optimizer(params)
        jitter = torch.Generator(device=self.device).manual_seed(seed + 1)
        param_gen = (torch.Generator(device=self.device).manual_seed(seed + 2)
                     if self.cfg.param_noise else None)
        snapshot = ({k: p.detach().clone() for k, p in params.items()}
                    if self.cfg.backtrack else {})
        return FitState(params=params, opt=opt, z=z, ema_out=None,
                        generator=jitter, snapshot=snapshot,
                        last_track=torch.zeros((), device=self.device), step=0,
                        device_step=torch.zeros((), dtype=torch.int64, device=self.device),
                        param_generator=param_gen)

    def _optimizer(self, params: dict[str, torch.Tensor]) -> torch.optim.Optimizer:
        if self.cfg.optimizer == "sgd":
            return torch.optim.SGD(params.values(), lr=self.cfg.lr)
        if self.cfg.optimizer == "lbfgs":
            return ZoomLBFGS(params.values())
        # capturable on CUDA whether the step is replayed or eager, so both
        # run the same arithmetic (the CPU does not allow it)
        return torch.optim.Adam(params.values(), lr=self.cfg.lr,
                                capturable=self.device.type == "cuda")

    def _weight_noise(self, state: FitState) -> dict[str, torch.Tensor]:
        """N(0,1) of each 4-D net parameter's shape, by name, from the
        weight-jitter generator."""
        return {k: torch.randn(w.shape, generator=state.param_generator, device=w.device,
                               dtype=w.dtype)
                for k, w in ((k, state.params[k]) for k in self.net_keys) if w.dim() == 4}

    def net_params(self, state: FitState, train: bool,
                   noise: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        """The net's parameters as a forward sees them, in f32: with
        param_noise and `train`, each 4-D one plus N(0,1) * std(w) / 50
        (std with ddof 0, as jnp.std), the N(0,1) from `noise` if given
        (_weight_noise's draws), else a fresh draw per call."""
        net = {k: state.params[k] for k in self.net_keys}
        if not (train and self.cfg.param_noise):
            return net
        for k, eps in (self._weight_noise(state) if noise is None else noise).items():
            w = net[k]
            net[k] = w + eps * (torch.std(w, correction=0) / 50.0)
        return net

    def _forward(self, net: dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
        if self.cfg.compute_dtype is None:
            # without weight jitter, `net` holds the model's own parameters
            return functional_call(self.model, net, (z,)) if self.cfg.param_noise else self.model(z)
        with span("dip.fit.cast"):
            cast = {k: v.to(torch.bfloat16) for k, v in net.items()}
            zc = z.to(torch.bfloat16)
        out = functional_call(self.model, cast, (zc,))
        with span("dip.fit.cast"):
            return out.to(torch.float32)

    def _base_input(self, state: FitState) -> torch.Tensor:
        return state.params["input"] if self.cfg.opt_input else state.z

    def _jitter(self, state: FitState) -> torch.Tensor | None:
        """This step's input jitter, std * N(0,1) (None without jitter)."""
        cfg = self.cfg
        if self._schedule is not None:
            std = schedule_std(state.device_step, *self._schedule)
        elif cfg.reg_noise_std > 0:
            std = cfg.reg_noise_std
        else:
            return None
        return std * torch.randn(state.z.shape, generator=state.generator,
                                 device=self.device, dtype=state.z.dtype)

    def _update(self, state: FitState, aux: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step, `state.opt.step(closure)`: the input and
        weight jitter drawn once, the closure a forward with those draws
        around the params as they stand, the loss and its backward (Adam
        and SGD call it once, L-BFGS's line search once a trial). Returns
        the loss and the output at the params before the update."""
        with span("dip.fit.jitter"):
            jitter = self._jitter(state)
            noise = self._weight_noise(state) if self.cfg.param_noise else None
        first: list[torch.Tensor] = []

        def closure():
            with span("dip.fit.forward"):
                # the jittered input and weights are arguments only: freed
                # when the forward returns, before the backward
                out = self._forward(*self._jittered(state, jitter, noise))
            with span("dip.fit.loss"):
                loss, value = self._loss(state.params, out, aux)
            with span("dip.fit.backward"):
                state.opt.zero_grad(set_to_none=True)
                loss.backward()
            if not first:
                # the output as computed: with a trainable z, an identity
                # net's output is the leaf itself, which the update changes
                first.append(out.detach().clone() if self.cfg.opt_input else out.detach())
            return value

        with span("dip.fit.optimizer"):
            return state.opt.step(closure).detach(), first[0]

    def _loss(self, params: dict[str, torch.Tensor], out: torch.Tensor,
              aux: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """(the loss to differentiate, the value the closure returns to the
        optimizer)."""
        loss = self.loss_fn(params, out, aux)
        return loss, loss

    def _step_metrics(self, out: torch.Tensor, ema: torch.Tensor, aux: Any) -> dict:
        return self.metrics_fn(out, ema, aux)

    def _jittered(self, state, jitter: torch.Tensor | None,
                  noise: dict[str, torch.Tensor] | None) -> tuple[dict, torch.Tensor]:
        """(the net's parameters, the input) as this step's forward sees
        them: the step's weight jitter and input jitter added."""
        with span("dip.fit.jitter"):
            net = self.net_params(state, True, noise)
            z = self._base_input(state)
            return net, (z if jitter is None else z + jitter)

    def _advance(self, state: FitState, aux: Any) -> dict:
        """One training step on the device, every buffer of `state` updated
        in place (its host `step` aside); returns the metrics, 0-d
        tensors (a batch's: one a fit). This is the body the CUDA graph
        captures."""
        cfg = self.cfg
        if cfg.backtrack:
            with span("dip.fit.backtrack"):
                pre = {k: p.detach().clone() for k, p in state.params.items()}
        loss, out = self._update(state, aux)

        with span("dip.fit.ema"):
            if state.ema_out is None:
                state.ema_out = torch.zeros_like(out)
            if cfg.exp_weight is None:
                ema = out
            else:
                w = cfg.exp_weight
                ema = torch.where(state.device_step == 0, out,
                                  state.ema_out * w + out * (1 - w))

        with span("dip.fit.metrics"):
            metrics = {"loss": loss}
            if cfg.optimizer == "lbfgs":
                metrics["evals"] = torch.tensor(state.opt.last_evals, dtype=torch.float32,
                                                device=self.device)
            if self.metrics_fn is not None:
                metrics.update(self._step_metrics(out, ema, aux))

        if cfg.backtrack:
            with span("dip.fit.backtrack"):
                track = metrics["psnr_track"]
                drop = (track - state.last_track) < -cfg.backtrack_threshold
                with torch.no_grad():
                    for k, p in state.params.items():
                        # a batch's drop, one a fit, on each leaf's fit axis
                        d = drop.view(-1, *[1] * (p.dim() - 1)) if drop.dim() else drop
                        snap = state.snapshot[k]
                        p.copy_(torch.where(d, snap, p))
                        snap.copy_(torch.where(d, snap, pre[k]))
                state.last_track.copy_(torch.where(drop, state.last_track, track))
                metrics["backtracked"] = drop.to(torch.float32)

        # the EMA and the step counter that picks its first step
        with span("dip.fit.ema"):
            state.ema_out.copy_(ema)
            state.device_step.add_(1)
        return metrics

    def step(self, state: FitState, aux: Any) -> tuple[FitState, dict]:
        """One eager training step; returns (state, metrics as 0-d device
        tensors)."""
        metrics = self._advance(state, aux)
        state.step += 1
        return state, metrics

    def _step_into(self, state: FitState, aux: Any, table: torch.Tensor,
                   slot: torch.Tensor, keys: tuple[str, ...]) -> None:
        """The step the graph holds: `_advance`, then its metrics into row
        `slot` of `table` and the slot moved on, all on the device."""
        _write_row(self._advance(state, aux), keys, table, slot)

    def _generators(self, state: FitState) -> list[torch.Generator]:
        """The generators a step draws from (a capture registers them)."""
        return [g for g in (state.generator, state.param_generator) if g is not None]

    def capture(self, state: FitState, aux: Any) -> None:
        """On a CUDA device, unless the state has a graph for `aux` already:
        take the fit's next step eagerly (what the capture needs exists
        after it), then capture the step in a CUDA graph with its own
        memory pool and both jitter generators registered, so each replay
        draws on from where the last step left the generators. That eager
        step is the first of the next chunk. A capture launches nothing: the
        counters it moved are taken back, and each replay adds them. Raises
        if the capture fails, and for L-BFGS, on any device: its line
        search reads each trial on the host. Nothing else to do on the CPU."""
        if self.cfg.optimizer == "lbfgs":
            raise RuntimeError("an L-BFGS step reads its line search on the host and cannot be "
                               "captured; run and run_chunk take its steps eagerly")
        g = state.graph
        if self._stream is None or (g is not None and g.aux is aux):
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with span("dip.fit.capture"), torch.cuda.device(self.device), \
                torch.cuda.stream(self._stream):
            _, metrics = self.step(state, aux)
            keys = tuple(metrics)
            # a row a step: the metrics, each of the shape the step gives it
            table = torch.zeros((self.cfg.log_every, len(keys), *metrics[keys[0]].shape),
                                device=self.device)
            slot = torch.zeros(1, dtype=torch.int64, device=self.device)
            _write_row(metrics, keys, table, slot)
            state.graph = None
            # a capture cannot free memory, so hand the pools of graphs that
            # are gone back to the card first (this waits for the device)
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            for gen in self._generators(state):
                graph.register_generator_state(gen)
            before = launches.counts()
            graph.capture_begin()
            try:
                self._step_into(state, aux, table, slot, keys)
            finally:
                graph.capture_end()
            # the gradients live in the graph's pool, which keeps them for the
            # replays; no tensor outside the graph holds that pool
            state.opt.zero_grad(set_to_none=True)
            captured = {k: v - before[k] for k, v in launches.counts().items()}
            launches.add(captured, -1)
            state.graph = _Graph(graph, aux, keys, table, slot, captured)

    def run_chunk(self, state: FitState, aux: Any, n: int) -> dict[str, torch.Tensor]:
        """`n` steps; returns each metric's (n,) device tensor. On CUDA the
        steps run on the fit's stream, as replays of the state's graph
        (captured first, as `capture` says, if the state has none for this
        aux), and nothing waits for them: `wait()` makes the caller's
        stream wait. On the CPU, and for L-BFGS on any device, eager steps;
        an L-BFGS fit's first chunk runs its Adam warm-up first (`_warmup`).
        n is at most cfg.log_every, the rows the graph writes."""
        if not 0 < n <= self.cfg.log_every:
            raise ValueError(f"a chunk is 1 to log_every={self.cfg.log_every} steps, not {n}")
        lbfgs = self.cfg.optimizer == "lbfgs"
        if lbfgs and state.step == 0 and self.cfg.lbfgs_warmup > 0:
            self._warmup(state, aux)
        if self._stream is None or lbfgs:
            hist = [self.step(state, aux)[1] for _ in range(n)]
            return {k: torch.stack([m[k] for m in hist]) for k in hist[0]}
        self.capture(state, aux)
        g = state.graph
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            if g.pending == 0:
                g.slot.zero_()
            for _ in range(g.pending, n):
                with span("dip.fit.replay"):
                    g.graph.replay()
                    launches.add(g.launches)
            state.step += n - g.pending
            g.pending = 0
            with span("dip.fit.rows"):
                return {k: g.table[:n, i].clone() for i, k in enumerate(g.keys)}

    def _warmup(self, state: FitState, aux: Any) -> None:
        """The L-BFGS fit's warm-up (the JAX engine's `_warmup`):
        cfg.lbfgs_warmup Adam steps at cfg.lbfgs_warmup_lr with
        backtracking off, through a copy of this engine with that Adam
        config (so a subclass warms up its own way) on this fit's model,
        params, EMA, jitter streams and step counters (graphed on CUDA);
        their metrics are dropped. Then a fresh L-BFGS state."""
        cfg = self.cfg
        warm = copy.copy(self)
        warm.cfg = dataclasses.replace(cfg, optimizer="adam", lr=cfg.lbfgs_warmup_lr,
                                       num_iter=cfg.lbfgs_warmup, backtrack=False)
        wstate = dataclasses.replace(state, opt=warm._optimizer(state.params), snapshot={},
                                     graph=None)
        warm.run(wstate, aux)
        if self._stream is not None:
            # the warm-up's graph and its pool go with wstate
            torch.cuda.synchronize(self.device)
        state.ema_out, state.step = wstate.ema_out, wstate.step
        state.opt = self._optimizer(state.params)

    def wait(self) -> None:
        """Make the caller's current stream wait for this fit's stream (no
        host sync); a no-op on the CPU."""
        if self._stream is not None:
            with span("dip.fit.wait"):
                torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def run(self, state: FitState, aux: Any,
            callback: Callable[[int, dict, FitState], None] | None = None):
        """Run cfg.num_iter steps in chunks of log_every (run_chunk). The
        host syncs at a chunk's end only if `callback` is given, else once
        at the end. Returns (state, history of per-step metrics as numpy
        arrays)."""
        remaining, it = self.cfg.num_iter, 0
        chunks: list[dict] = []
        while remaining > 0:
            n = min(self.cfg.log_every, remaining)
            chunks.append(self.run_chunk(state, aux, n))
            self.wait()
            remaining -= n
            it += n
            if callback is not None:
                callback(it, {k: v.cpu().numpy() for k, v in chunks[-1].items()}, state)
        return state, concat_history(chunks)

    def render(self, state: FitState) -> torch.Tensor:
        """Final forward pass with the un-jittered input (the trainable z
        when z is optimised), copied so that an identity net's render is
        no view of a trainable leaf."""
        with torch.no_grad():
            return self._forward(self.net_params(state, train=False),
                                 self._base_input(state).clone())


def init_fit(model: torch.nn.Module, loss_fn: Callable, cfg: FitConfig, seed: int,
             z: torch.Tensor, aux: Any = None, metrics_fn: Callable | None = None,
             extra_params: dict | None = None, *, device: torch.device | str):
    """(engine, state): dip_tpu.fit.engine.init_fit with a seed and a
    device for the key."""
    del aux
    eng = Engine(model, loss_fn, cfg, metrics_fn, device=device)
    return eng, eng.init_state(seed, z, extra_params)


def fit(model: torch.nn.Module, loss_fn: Callable, cfg: FitConfig, seed: int,
        z: torch.Tensor, aux: Any = None, metrics_fn: Callable | None = None,
        callback: Callable | None = None, extra_params: dict | None = None, *,
        device: torch.device | str):
    """One-call fit, `aux` on the fit's device. Returns (final output
    image, final state, history)."""
    eng, state = init_fit(model, loss_fn, cfg, seed, z, aux, metrics_fn, extra_params,
                          device=device)
    state, history = eng.run(state, aux, callback)
    return eng.render(state), state, history


def default_metrics(target: torch.Tensor, gt: torch.Tensor | None = None):
    """PSNR vs the fit target (tracked for backtracking), plus PSNR of the
    raw and EMA outputs vs the ground truth when given."""
    def fn(out, ema, aux):
        m = {"psnr_track": psnr(out, target)}
        if gt is not None:
            m["psnr_gt"] = psnr(out, gt)
            m["psnr_gt_sm"] = psnr(ema, gt)
        return m
    return fn
