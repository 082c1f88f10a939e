"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: compile dip_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. kernel parity: each seam kernel (fwd, dgrad, wgrad) against its plain
     PyTorch version at the five flagship seam shapes in bf16 and f32 and
     at one ragged shape, with times at the flagship shapes;
  4. small-input reference: a 2-scale 128-channel skip net, forward and
     gradients on the card against the same net on the CPU;
  5. main path: the flagship denoising fit (tasks.denoise 'f16', 512^2,
     run_task) for 30 steps in bf16 and in f32, with launch counters
     showing every step went through the three kernels;
  6. no host sync: three more flagship steps per dtype under torch's sync
     debug mode, which raises on any call that waits for the device.
The last three lines are the card line, a JSON object of the kernels, and
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

# max-normalised relative error max|kernel - plain| / max|plain|. f32 mode:
# identical bf16-rounded operands, f32 sums in another order. bf16 mode:
# the same, then one bf16 rounding of each result.
TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
FLAGSHIP_SEAMS = [(1, h, h, 128, 128) for h in (16, 32, 64, 128, 256)]
RAGGED_SEAM = (2, 12, 20, 8, 16)
MAIN_STEPS = 30
KERNELS = {
    "fwd": ("dip_tpu_torch/csrc/up_conv.cu", "dip_tpu/ops/pallas_up_conv.py:233"),
    "dgrad": ("dip_tpu_torch/csrc/up_conv.cu", "dip_tpu/ops/pallas_up_conv.py:307"),
    "wgrad": ("dip_tpu_torch/csrc/up_conv.cu", "dip_tpu/ops/pallas_up_conv.py:369"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    a, b = a.float(), b.float()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError("non-finite values in a kernel comparison")
    abs_err = (a - b).abs().max().item()
    return abs_err / max(b.abs().max().item(), 1e-30), abs_err


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    from dip_tpu_torch.bench import card_line

    card = card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from dip_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {_build.library_path().name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def phase_kernel_parity(dev: torch.device) -> dict:
    from dip_tpu_torch.ops import hopper_up_conv as H

    stats = {k: {"max_abs_err": 0.0} for k in KERNELS}
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for n, h, w, c, f in FLAGSHIP_SEAMS + [RAGGED_SEAM]:
            xp = torch.randn((n, h + 2, w + 2, c), generator=gen, device=dev).to(dtype)
            e = (torch.randn((3, 3, c, 4 * f), generator=gen, device=dev) * 0.05).to(dtype)
            dzq = torch.randn((n, h, w, 4 * f), generator=gen, device=dev).to(torch.bfloat16)
            pairs = {
                "fwd": (lambda: H.fwd(xp, e), lambda: H.fwd_plain(xp, e)),
                "dgrad": (lambda: H.dgrad(dzq, e, dtype),
                          lambda: H.dgrad_plain(dzq, e, dtype)),
                "wgrad": (lambda: H.wgrad(xp, dzq), lambda: H.wgrad_plain(xp, dzq)),
            }
            for name, (kern, plain) in pairs.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise RuntimeError(f"{name} {tuple(got.shape)} {got.dtype} vs "
                                       f"{tuple(want.shape)} {want.dtype}")
                rel, abs_err = rel_err(got, want)
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], abs_err)
                line = (f"[parity] {name:5s} {str(dtype)[6:]:8s} N={n} h={h} w={w} C={c} "
                        f"F={f}: rel {rel:.2e} abs {abs_err:.2e}")
                if (n, h, w, c, f) != RAGGED_SEAM:
                    reps = 20 if h <= 64 else 5
                    ms, plain_ms = time_ms(kern, reps), time_ms(plain, reps)
                    line += f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                    if h == 256 and dtype == torch.bfloat16:
                        stats[name].update(ms=ms, plain_ms=plain_ms)
                log(line)
                if rel > TOL[dtype]:
                    raise RuntimeError(f"{name} disagrees with its plain version: "
                                       f"rel {rel:.3e} > {TOL[dtype]}")
            del xp, e, dzq, pairs
    return stats


def phase_small_reference(dev: torch.device) -> None:
    """The flagship-shaped net at 2 scales and 32^2 (decoder seams at LR 8
    and 16): forward and all gradients on the card vs the CPU, same weights."""
    from dip_tpu_torch.models import Skip

    def net():
        return Skip(num_input_channels=8, num_channels_down=[128] * 2,
                    num_channels_up=[128] * 2, num_channels_skip=[4] * 2,
                    upsample_mode="bilinear", pad="reflection")

    cpu, gpu = net(), net()
    cpu.reset_parameters(torch.Generator().manual_seed(3))
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.normal(size=(1, 32, 32, 8)).astype(np.float32)) * 0.1
    tgt = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32))
    outs, grads = [], []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        out = model(z.to(d))
        loss = torch.mean((out - tgt.to(d)) ** 2)
        grads.append([g.cpu() for g in torch.autograd.grad(loss, list(model.parameters()))])
        outs.append(out.detach().cpu())
    torch.cuda.synchronize()
    _, out_abs = rel_err(outs[1], outs[0])
    # each gradient's error against the largest gradient of the net: the
    # scale of a BN that feeds another BN has a gradient that is rounding
    # noise (exactly zero in exact arithmetic), so its own max is no norm
    g_max = max(g.abs().max().item() for g in grads[0])
    worst = max((g1 - g0).abs().max().item() for g0, g1 in zip(*grads)) / g_max
    log(f"[small] skip 2x128 @32^2 cuda vs cpu: out max abs {out_abs:.2e}, "
        f"grads max err / max grad {worst:.2e}")
    if out_abs > 2e-3 or worst > 2e-2:
        raise RuntimeError("small-input forward/gradients disagree with the CPU")


def phase_main_path(dev: torch.device, card: str) -> dict:
    from dip_tpu_torch.bench import synthetic_noisy
    from dip_tpu_torch.fit.engine import tf32_flags
    from dip_tpu_torch.ops import hopper_up_conv as H
    from dip_tpu_torch.tasks import denoise
    from dip_tpu_torch.tasks.base import run_task

    clean, noisy = synthetic_noisy(512)
    H.reset_launches()
    for cd in ("bfloat16", None):
        spec = denoise.task(noisy, "f16", gt=clean, num_iter=MAIN_STEPS)
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, compute_dtype=cd, log_every=10))
        before = dict(H.LAUNCHES)
        marks: list[tuple[int, float]] = []
        torch.cuda.reset_peak_memory_stats(dev)
        out, _, hist = run_task(spec, 0, device=dev,
                                callback=lambda it, h, s: marks.append((it, time.perf_counter())))
        out = out.cpu()
        delta = {k: H.LAUNCHES[k] - before[k] for k in H.LAUNCHES}
        want = {"fwd": 5 * MAIN_STEPS + 5, "dgrad": 5 * MAIN_STEPS, "wgrad": 5 * MAIN_STEPS}
        loss = hist["loss"]
        tag = cd or "float32"
        (i0, t0), (i1, t1) = marks[0], marks[-1]
        ips = (i1 - i0) / (t1 - t0)
        log(f"[main] {tag}: {ips:.2f} it/s, {1e3 / ips:.2f} ms/step (steps {i0 + 1}-{i1}) "
            f"| loss {loss[0]:.5f} -> {loss[-1]:.5f} | psnr_gt {hist['psnr_gt'][-1]:.2f} dB "
            f"| backtracked {int(hist['backtracked'].sum())} | peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB | launches {delta} "
            f"| {tf32_flags()} | card {card}")
        if delta != want:
            raise RuntimeError(f"launch counts {delta} != {want}")
        if not np.isfinite(loss).all() or not loss[-1] < loss[0]:
            raise RuntimeError(f"loss not finite and falling: {loss}")
        if out.shape != (1, 512, 512, 3) or not torch.isfinite(out).all():
            raise RuntimeError(f"bad output {tuple(out.shape)}")
    return dict(H.LAUNCHES)


def phase_step_without_sync(dev: torch.device) -> None:
    """Engine.step of the flagship fit only enqueues work: under torch's
    sync debug mode any call that makes the host wait for the device (a
    read of a device value, a copy from pageable host memory) raises."""
    from dip_tpu_torch.bench import synthetic_noisy
    from dip_tpu_torch.fit.engine import Engine
    from dip_tpu_torch.tasks import denoise
    from dip_tpu_torch.tasks.base import make_input, to_device

    clean, noisy = synthetic_noisy(512)
    for cd in ("bfloat16", None):
        spec = denoise.task(noisy, "f16", gt=clean)
        eng = Engine(spec.model, spec.loss_fn,
                     dataclasses.replace(spec.cfg, compute_dtype=cd),
                     spec.metrics_fn, device=dev)
        state = eng.init_state(1, make_input(spec, torch.Generator().manual_seed(0), dev))
        aux = to_device(spec.aux, dev)
        eng.step(state, aux)  # first step: device constants, optimizer state
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                eng.step(state, aux)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        log(f"[sync] {cd or 'float32'}: 3 flagship steps (jitter, EMA, backtracking) "
            f"made no host sync")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dip_tpu_torch.fit.engine import disable_tf32

    dev = torch.device("cuda", 0)
    disable_tf32()
    card = phase_device()
    phase_build()
    stats = phase_kernel_parity(dev)
    phase_small_reference(dev)
    launches = phase_main_path(dev, card)
    phase_step_without_sync(dev)
    kernels = [{"name": f"up_conv_{k}", "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], "max_abs_err": stats[k]["max_abs_err"],
                "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"]}
               for k, (src, rep) in KERNELS.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
