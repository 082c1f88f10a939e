"""The DIP fit loop: jitter, forward, loss, backward, Adam, EMA, metrics and
PSNR backtracking, one step at a time on one device.

Counterpart of dip_tpu/fit/engine.py, which scans the same step body on
device. Here PyTorch runs eagerly; the loop stays free of host syncs
inside a `log_every` chunk: metrics stay 0-d device tensors, and
backtracking restores or refreshes its on-device snapshot with
torch.where on a device-side condition.

Semantics (as the JAX engine):
 - input jitter: z_used = z + N(0,1) * reg_noise_std each step;
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
 - compute_dtype='bfloat16': the net's params and z are cast each step
   (master params stay f32, the output goes back to f32 before the loss);
   no autocast. Extra trainable leaves stay f32.
 - optimize-over: the trainable set is the net's parameters, plus the
   input z ('input' in opt_over, or opt_input), plus each extra leaf
   (e.g. 'down', a learnable degradation kernel). All of them go to Adam
   and to the backtracking snapshot; loss_fn sees them by name. With a
   trainable z the jitter is drawn around its current value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.func import functional_call

from dip_tpu_torch.ops.losses import psnr


@dataclasses.dataclass(frozen=True)
class FitConfig:
    num_iter: int = 3000
    lr: float = 0.01
    optimizer: str = "adam"
    reg_noise_std: float = 0.0        # input jitter std
    param_noise: bool = False         # conv-weight jitter
    exp_weight: float | None = None   # EMA factor, e.g. 0.99
    backtrack: bool = False
    backtrack_threshold: float = 5.0
    log_every: int = 100              # steps between host syncs
    compute_dtype: str | None = None  # 'bfloat16' for mixed precision
    opt_input: bool = False           # optimise z as well
    opt_over: str = "net"             # 'net,input,down'; 'input' sets opt_input


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
    step: int
    param_generator: torch.Generator | None = None  # weight jitter (param_noise)


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


class Engine:
    """Per-image DIP fit.

    Args:
        model: an nn.Module mapping z (1,H,W,Cin) -> image (1,H,W,Cout),
            moved to `device` here.
        loss_fn: (params, out, aux) -> 0-d loss tensor; params holds every
            trainable leaf by name (extra leaves as given to init_state).
        cfg: FitConfig.
        metrics_fn: optional (out, ema_out, aux) -> dict of 0-d tensors; with
            backtracking it must give 'psnr_track' (PSNR vs the fit target).
        device: where the fit runs ('cuda' or 'cpu'); no default.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, cfg: FitConfig,
                 metrics_fn: Callable | None = None, *, device: torch.device | str):
        if cfg.optimizer != "adam":
            raise ValueError(f"optimizer {cfg.optimizer!r} is not ported yet; only 'adam'")
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
        opt = torch.optim.Adam(params.values(), lr=self.cfg.lr)
        jitter = torch.Generator(device=self.device).manual_seed(seed + 1)
        param_gen = (torch.Generator(device=self.device).manual_seed(seed + 2)
                     if self.cfg.param_noise else None)
        snapshot = ({k: p.detach().clone() for k, p in params.items()}
                    if self.cfg.backtrack else {})
        return FitState(params=params, opt=opt, z=z, ema_out=None,
                        generator=jitter, snapshot=snapshot,
                        last_track=torch.zeros((), device=self.device), step=0,
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

    def step(self, state: FitState, aux: Any) -> tuple[FitState, dict]:
        cfg = self.cfg
        z_used = self._base_input(state)
        if cfg.reg_noise_std > 0:
            z_used = z_used + cfg.reg_noise_std * torch.randn(
                state.z.shape, generator=state.generator, device=self.device,
                dtype=state.z.dtype)
        out = self._forward(self.net_params(state, train=True), z_used)
        loss = self.loss_fn(state.params, out, aux)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        # the output as computed: with a trainable z, an identity net's
        # output is the leaf itself, which the update changes in place
        out = out.detach().clone() if cfg.opt_input else out.detach()
        if cfg.backtrack:
            pre = {k: p.detach().clone() for k, p in state.params.items()}
        state.opt.step()

        if cfg.exp_weight is None or state.step == 0:
            ema = out
        else:
            ema = state.ema_out * cfg.exp_weight + out * (1 - cfg.exp_weight)

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
                    state.snapshot[k] = torch.where(drop, snap, pre[k])
            state.last_track = torch.where(drop, state.last_track, track)
            metrics["backtracked"] = drop.to(torch.float32)

        state.ema_out = ema
        state.step += 1
        return state, metrics

    def run(self, state: FitState, aux: Any,
            callback: Callable[[int, dict, FitState], None] | None = None):
        """Run cfg.num_iter steps in chunks of log_every. The host syncs at a
        chunk's end only if `callback` is given, else once at the end.
        Returns (state, history of per-step metrics as numpy arrays)."""
        remaining, it = self.cfg.num_iter, 0
        chunks: list[dict] = []
        while remaining > 0:
            n = min(self.cfg.log_every, remaining)
            hist = [self.step(state, aux)[1] for _ in range(n)]
            chunks.append({k: torch.stack([m[k] for m in hist]) for k in hist[0]})
            remaining -= n
            it += n
            if callback is not None:
                callback(it, {k: v.cpu().numpy() for k, v in chunks[-1].items()}, state)
        history = {k: torch.cat([c[k] for c in chunks]).cpu().numpy() for k in chunks[0]}
        return state, history

    def render(self, state: FitState) -> torch.Tensor:
        """Final forward pass with the un-jittered input (the trainable z
        when z is optimised), copied so that an identity net's render is
        no view of a trainable leaf."""
        with torch.no_grad():
            return self._forward(self.net_params(state, train=False),
                                 self._base_input(state).clone())


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
