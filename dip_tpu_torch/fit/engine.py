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
the step number.

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
   defaults); 'lbfgs' is not ported yet.
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

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from dip_tpu_torch.ops import launches
from dip_tpu_torch.ops.losses import psnr

OPTIMIZERS = ("adam", "sgd")


@dataclasses.dataclass(frozen=True)
class FitConfig:
    num_iter: int = 3000
    lr: float = 0.01
    optimizer: str = "adam"           # 'adam' | 'sgd' ('lbfgs' is not ported yet)
    reg_noise_std: float = 0.0        # input jitter std
    param_noise: bool = False         # conv-weight jitter
    exp_weight: float | None = None   # EMA factor, e.g. 0.99
    backtrack: bool = False
    backtrack_threshold: float = 5.0
    log_every: int = 100              # steps between host syncs
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
        if cfg.optimizer == "lbfgs":
            raise ValueError("optimizer 'lbfgs' is not ported yet; use 'adam' or 'sgd'")
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
        if self.cfg.optimizer == "sgd":
            opt = torch.optim.SGD(params.values(), lr=self.cfg.lr)
        else:
            # capturable on CUDA whether the step is replayed or eager, so
            # both run the same arithmetic (the CPU does not allow it)
            opt = torch.optim.Adam(params.values(), lr=self.cfg.lr,
                                   capturable=self.device.type == "cuda")
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

    def net_params(self, state: FitState, train: bool) -> dict[str, torch.Tensor]:
        """The net's parameters as a forward sees them, in f32: with
        param_noise and `train`, each 4-D one plus N(0,1) * std(w) / 50
        (std with ddof 0, as jnp.std), a fresh draw per call."""
        net = {k: state.params[k] for k in self.net_keys}
        if not (train and self.cfg.param_noise):
            return net
        for k, w in net.items():
            if w.dim() == 4:
                noise = torch.randn(w.shape, generator=state.param_generator,
                                    device=w.device, dtype=w.dtype)
                net[k] = w + noise * (torch.std(w, correction=0) / 50.0)
        return net

    def _forward(self, net: dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
        if self.cfg.compute_dtype is None:
            # without weight jitter, `net` holds the model's own parameters
            return functional_call(self.model, net, (z,)) if self.cfg.param_noise else self.model(z)
        cast = {k: v.to(torch.bfloat16) for k, v in net.items()}
        return functional_call(self.model, cast, (z.to(torch.bfloat16),)).to(torch.float32)

    def _base_input(self, state: FitState) -> torch.Tensor:
        return state.params["input"] if self.cfg.opt_input else state.z

    def _jittered_input(self, state: FitState) -> torch.Tensor:
        cfg = self.cfg
        z = self._base_input(state)
        if self._schedule is not None:
            std = schedule_std(state.device_step, *self._schedule)
        elif cfg.reg_noise_std > 0:
            std = cfg.reg_noise_std
        else:
            return z
        return z + std * torch.randn(state.z.shape, generator=state.generator,
                                     device=self.device, dtype=state.z.dtype)

    def _advance(self, state: FitState, aux: Any) -> dict:
        """One training step on the device, every buffer of `state` updated
        in place (its host `step` aside); returns the metrics, 0-d
        tensors. This is the body the CUDA graph captures."""
        cfg = self.cfg
        out = self._forward(self.net_params(state, train=True), self._jittered_input(state))
        loss = self.loss_fn(state.params, out, aux)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        # the output as computed: with a trainable z, an identity net's
        # output is the leaf itself, which the update changes in place
        out = out.detach().clone() if cfg.opt_input else out.detach()
        if cfg.backtrack:
            pre = {k: p.detach().clone() for k, p in state.params.items()}
        state.opt.step()

        if state.ema_out is None:
            state.ema_out = torch.zeros_like(out)
        if cfg.exp_weight is None:
            ema = out
        else:
            w = cfg.exp_weight
            ema = torch.where(state.device_step == 0, out,
                              state.ema_out * w + out * (1 - w))

        metrics = {"loss": loss.detach()}
        if self.metrics_fn is not None:
            metrics.update(self.metrics_fn(out, ema, aux))

        if cfg.backtrack:
            track = metrics["psnr_track"]
            drop = (track - state.last_track) < -cfg.backtrack_threshold
            with torch.no_grad():
                for k, p in state.params.items():
                    snap = state.snapshot[k]
                    p.copy_(torch.where(drop, snap, p))
                    snap.copy_(torch.where(drop, snap, pre[k]))
            state.last_track.copy_(torch.where(drop, state.last_track, track))
            metrics["backtracked"] = drop.to(torch.float32)

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

    def capture(self, state: FitState, aux: Any) -> None:
        """On a CUDA device, unless the state has a graph for `aux` already:
        take the fit's next step eagerly (what the capture needs exists
        after it), then capture the step in a CUDA graph with its own
        memory pool and both jitter generators registered, so each replay
        draws on from where the last step left the generators. That eager
        step is the first of the next chunk. A capture launches nothing: the
        counters it moved are taken back, and each replay adds them. Raises
        if the capture fails. Nothing to do on the CPU."""
        g = state.graph
        if self._stream is None or (g is not None and g.aux is aux):
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            _, metrics = self.step(state, aux)
            keys = tuple(metrics)
            table = torch.zeros((self.cfg.log_every, len(keys)), device=self.device)
            slot = torch.zeros(1, dtype=torch.int64, device=self.device)
            _write_row(metrics, keys, table, slot)
            state.graph = None
            # a capture cannot free memory, so hand the pools of graphs that
            # are gone back to the card first (this waits for the device)
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            for gen in (state.generator, state.param_generator):
                if gen is not None:
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
        stream wait. On the CPU, eager steps. n is at most cfg.log_every, the
        rows the graph writes."""
        if not 0 < n <= self.cfg.log_every:
            raise ValueError(f"a chunk is 1 to log_every={self.cfg.log_every} steps, not {n}")
        if self._stream is None:
            hist = [self.step(state, aux)[1] for _ in range(n)]
            return {k: torch.stack([m[k] for m in hist]) for k in hist[0]}
        self.capture(state, aux)
        g = state.graph
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            if g.pending == 0:
                g.slot.zero_()
            for _ in range(g.pending, n):
                g.graph.replay()
                launches.add(g.launches)
            state.step += n - g.pending
            g.pending = 0
            return {k: g.table[:n, i].clone() for i, k in enumerate(g.keys)}

    def wait(self) -> None:
        """Make the caller's current stream wait for this fit's stream (no
        host sync); a no-op on the CPU."""
        if self._stream is not None:
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
