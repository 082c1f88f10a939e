"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: compile dip_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  3. kernel parity: each seam kernel (fwd, fwd with the carry-in, dgrad,
     wgrad) against its plain PyTorch version at the five flagship seam
     shapes in bf16 and f32 and at one ragged shape, with times at the
     flagship shapes; the downsample kernel against its plain version at
     the SR geometries (x4 and x8 at HR 384x576, a ragged batch, gauss12,
     box, preserve_size=False), with times;
  4. small-input reference: a 2-scale 128-channel skip net, forward and
     gradients on the card against the same net on the CPU: under an MSE
     at full resolution, and under the SR loss (x4 downsample, MSE at LR)
     with the seam's carry-in off and on;
  5. main paths: the flagship denoising fit (tasks.denoise 'f16', 512^2,
     run_task) for 30 steps in bf16 and in f32; then the SR fit
     (tasks.super_resolve x4, HR 384x576, run_task) for 30 steps in bf16,
     in f32 and in bf16 with the carry-in. Launch counters, set to 0 before
     each path and read after it, show that every step went through the
     kernels;
  6. no host sync: three more steps per dtype of each fit under torch's
     sync debug mode, which raises on any call that waits for the device.
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
    "fwd_carry": ("dip_tpu_torch/csrc/up_conv.cu", "dip_tpu/ops/pallas_up_conv.py:233"),
    "dgrad": ("dip_tpu_torch/csrc/up_conv.cu", "dip_tpu/ops/pallas_up_conv.py:307"),
    "wgrad": ("dip_tpu_torch/csrc/up_conv.cu", "dip_tpu/ops/pallas_up_conv.py:369"),
}
DOWNSAMPLE = ("dip_tpu_torch/csrc/resample.cu", "dip_tpu/ops/pallas_resample.py:119")
# the downsample kernel against its plain version: true f32 on both sides
# (FMA chains against banded f32 matmuls with TF32 off), sums in another order
DOWN_TOL = 1e-5
SR_HR = (384, 576)  # super-resolution.ipynb's zebra, cropped to a multiple of 32
# (N, H, W, C), factor, kernel_type, phase, preserve_size, kernel_width
DOWN_CASES = [
    ((1, *SR_HR, 3), 4, "lanczos2", 0.5, True, None),
    ((1, *SR_HR, 3), 8, "lanczos2", 0.5, True, None),
    ((2, 70, 45, 3), 3, "lanczos2", 0.5, True, None),
    ((1, *SR_HR, 3), 2, "gauss12", 0.0, True, None),
    ((1, *SR_HR, 3), 4, "box", 0.5, True, 4),
    ((1, *SR_HR, 3), 4, "lanczos2", 0.5, False, None),
]


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
            carry = torch.randn((n, 2 * h, 2 * w, f), generator=gen, device=dev).to(dtype)
            pairs = {
                "fwd": (lambda: H.fwd(xp, e), lambda: H.fwd_plain(xp, e)),
                "fwd_carry": (lambda: H.fwd(xp, e, carry), lambda: H.fwd_plain(xp, e, carry)),
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
                line = (f"[parity] {name:9s} {str(dtype)[6:]:8s} N={n} h={h} w={w} C={c} "
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
            del xp, e, dzq, carry, pairs
    return stats


def phase_downsample_parity(dev: torch.device) -> dict:
    """The downsample kernel against downsample_plain on the card."""
    from dip_tpu_torch.ops import hopper_resample as HR
    from dip_tpu_torch.ops import resample as R

    stats = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape, factor, ktype, phase, preserve, width in DOWN_CASES:
        x = torch.rand(shape, generator=gen, device=dev)
        spec = R._spec(factor, ktype, phase, width, None, None)
        pad, h_out, w_out = R._geometry(x.shape, spec, preserve)
        taps = R.device_const(R._profile, spec, torch.float32, dev)

        def kern():
            return HR.downsample_fused(x, taps, factor, pad, h_out, w_out)

        def plain():
            return R.downsample_plain(x, factor, ktype, phase, preserve, width)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.shape != (shape[0], h_out, w_out, shape[3]):
            raise RuntimeError(f"downsample {tuple(got.shape)} vs {tuple(want.shape)}")
        rel, abs_err = rel_err(got, want)
        ms, plain_ms = time_ms(kern, 50), time_ms(plain, 50)
        stats["max_abs_err"] = max(stats["max_abs_err"], abs_err)
        stats["max_rel_err"] = max(stats["max_rel_err"], rel)
        if (factor, ktype, preserve, shape[0]) == (4, "lanczos2", True, 1):
            stats.update(ms=ms, plain_ms=plain_ms)
        log(f"[parity] downsample {tuple(shape)} x{factor} {ktype} phase {phase} "
            f"preserve {preserve} -> {tuple(got.shape)} K={taps.shape[0]} p={pad} "
            f"tile {HR.tile_plan(taps.shape[0], factor, shape[3])[:2]}: rel {rel:.2e} "
            f"abs {abs_err:.2e} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if rel > DOWN_TOL:
            raise RuntimeError(f"downsample disagrees with its plain version: "
                               f"rel {rel:.3e} > {DOWN_TOL}")
    return stats


def phase_small_reference(dev: torch.device) -> None:
    """The flagship-shaped net at 2 scales and 32^2 (decoder seams at LR 8
    and 16): forward and all gradients on the card vs the CPU, same weights.
    Under an MSE at full resolution, and under the SR loss (x4 downsample,
    then an MSE at LR 8^2) with the seam's carry-in off and on, which holds
    the downsample kernel's adjoint and the carry's backward on the card."""
    from dip_tpu_torch.models import Skip
    from dip_tpu_torch.ops.resample import downsample

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
    tgt_lr = torch.from_numpy(rng.random((1, 8, 8, 3)).astype(np.float32))
    cases = (("mse at 32^2", False, lambda out, d: torch.mean((out - tgt.to(d)) ** 2)),
             ("sr x4 lanczos2, mse at 8^2", False,
              lambda out, d: torch.mean((downsample(out, 4, "lanczos2", 0.5, True)
                                         - tgt_lr.to(d)) ** 2)))
    cases += (("sr x4 lanczos2, mse at 8^2, seam carry", True, cases[1][2]),)
    for what, carry, loss_of in cases:
        outs, grads = [], []
        for model, d in ((cpu, "cpu"), (gpu, dev)):
            model.seam_carry = carry
            out = model(z.to(d))
            loss = loss_of(out, d)
            grads.append([g.cpu() for g in torch.autograd.grad(loss, list(model.parameters()))])
            outs.append(out.detach().cpu())
        torch.cuda.synchronize()
        _, out_abs = rel_err(outs[1], outs[0])
        # each gradient's error against the largest gradient of the net: the
        # scale of a BN that feeds another BN has a gradient that is rounding
        # noise (exactly zero in exact arithmetic), so its own max is no norm
        g_max = max(g.abs().max().item() for g in grads[0])
        worst = max((g1 - g0).abs().max().item() for g0, g1 in zip(*grads)) / g_max
        log(f"[small] skip 2x128 @32^2, {what}: cuda vs cpu: out max abs {out_abs:.2e}, "
            f"grads max err / max grad {worst:.2e}")
        if out_abs > 2e-3 or worst > 2e-2:
            raise RuntimeError(f"small-input forward/gradients disagree with the CPU ({what})")


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
        want = {"fwd": 5 * MAIN_STEPS + 5, "fwd_carry": 0, "dgrad": 5 * MAIN_STEPS,
                "wgrad": 5 * MAIN_STEPS}
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


def synthetic_sr(factor: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """(HR, LR): a (1, 384, 576, 3) smooth image with texture, made with
    numpy, and its factor x factor block mean. The recipe's LR comes from
    PIL's Lanczos resize, which the CPU tests cover; Pillow is not needed
    here."""
    h, w = SR_HR
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    hr = np.stack([np.sin(xx / 19) * np.cos(yy / 31) * 0.5 + 0.5,
                   np.cos((xx + yy) / 13) * 0.4 + 0.5,
                   (np.sin(xx / 5) * np.sin(yy / 7) * 0.2 + (xx + yy) / (h + w) * 0.6)],
                  axis=-1)
    hr = np.clip(hr + np.random.default_rng(0).random(hr.shape) * 0.05, 0, 1)
    lr = hr.reshape(h // factor, factor, w // factor, factor, 3).mean((1, 3))
    return hr[None].astype(np.float32), lr[None].astype(np.float32)


def _sr_spec(cd: str | None, carry: bool):
    from dip_tpu_torch.tasks import super_resolve

    hr, lr = synthetic_sr()
    spec = super_resolve.task(lr, factor=4, hr_gt=hr, num_iter=MAIN_STEPS)
    spec.model.seam_carry = carry
    return dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, compute_dtype=cd, log_every=10))


def phase_sr_path(dev: torch.device, card: str) -> dict:
    """The SR fit (x4, HR 384x576, Skip 5x128) through run_task, in bf16,
    in f32 and in bf16 with the seam's carry-in: falling loss, rising
    psnr_lr, and the launch counts the code implies."""
    from dip_tpu_torch.fit.engine import tf32_flags
    from dip_tpu_torch.ops import hopper_resample as HR
    from dip_tpu_torch.ops import hopper_up_conv as H
    from dip_tpu_torch.tasks.base import run_task

    log("[sr] LR observation: 4x4 block mean of a synthetic HR image made with numpy "
        "(the recipe's PIL Lanczos LR is covered by the CPU tests)")
    H.reset_launches()
    HR.reset_launches()
    for cd, carry in (("bfloat16", False), (None, False), ("bfloat16", True)):
        spec = _sr_spec(cd, carry)
        before = {**H.LAUNCHES, **HR.LAUNCHES}
        marks: list[tuple[int, float]] = []
        torch.cuda.reset_peak_memory_stats(dev)
        out, _, hist = run_task(spec, 0, device=dev,
                                callback=lambda it, h, s: marks.append((it, time.perf_counter())))
        out = out.cpu()
        delta = {k: v - before[k] for k, v in {**H.LAUNCHES, **HR.LAUNCHES}.items()}
        # per step: one downsample in the loss and one in the metrics (its
        # backward is PyTorch); each of the 5 seams runs fwd, dgrad and
        # wgrad, and the render runs each seam's fwd once more. With the
        # carry-in, a seam whose scale has a skip branch runs fwd_carry.
        n_seams = len(spec.model.ch_skip)
        carried = sum(1 for c in spec.model.ch_skip if c) if carry else 0
        fwds = MAIN_STEPS + 1
        want = {"fwd": fwds * (n_seams - carried), "fwd_carry": fwds * carried,
                "dgrad": MAIN_STEPS * n_seams, "wgrad": MAIN_STEPS * n_seams,
                "downsample": 2 * MAIN_STEPS}
        loss, p_lr = hist["loss"], hist["psnr_lr"]
        tag = (cd or "float32") + (" carry" if carry else "")
        (i0, t0), (i1, t1) = marks[0], marks[-1]
        ips = (i1 - i0) / (t1 - t0)
        log(f"[sr] {tag}: {ips:.2f} it/s, {1e3 / ips:.2f} ms/step (steps {i0 + 1}-{i1}) "
            f"| loss {loss[0]:.5f} -> {loss[-1]:.5f} | psnr_lr {p_lr[0]:.2f} -> "
            f"{p_lr[-1]:.2f} dB | psnr_hr {hist['psnr_hr'][-1]:.2f} dB | backtracked "
            f"{int(hist['backtracked'].sum())} | peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB | launches {delta} "
            f"| {tf32_flags()} | card {card}")
        if delta != want:
            raise RuntimeError(f"launch counts {delta} != {want}")
        if not np.isfinite(loss).all() or not loss[-1] < loss[0] or not p_lr[-1] > p_lr[0]:
            raise RuntimeError(f"loss not finite and falling, or psnr_lr not rising: "
                               f"{loss}, {p_lr}")
        if out.shape != (1, *SR_HR, 3) or not torch.isfinite(out).all():
            raise RuntimeError(f"bad output {tuple(out.shape)}")
    return {**H.LAUNCHES, **HR.LAUNCHES}


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


def phase_sr_step_without_sync(dev: torch.device) -> None:
    """The same check for the SR fit's step (the downsample kernel in the
    loss and the metrics, its PyTorch adjoint, the carry-in seams)."""
    from dip_tpu_torch.fit.engine import Engine
    from dip_tpu_torch.tasks.base import make_input, to_device

    for cd, carry in (("bfloat16", True), (None, False)):
        spec = _sr_spec(cd, carry)
        eng = Engine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn, device=dev)
        state = eng.init_state(1, make_input(spec, torch.Generator().manual_seed(0), dev),
                               spec.extra_params)
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
        log(f"[sync] sr {cd or 'float32'}{' carry' if carry else ''}: 3 SR steps "
            f"(jitter, downsample, backtracking) made no host sync")


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
    down = phase_downsample_parity(dev)
    phase_small_reference(dev)
    launches = phase_main_path(dev, card)
    sr_launches = phase_sr_path(dev, card)
    phase_step_without_sync(dev)
    phase_sr_step_without_sync(dev)
    # each kernel's launches come from the main path that runs it: the
    # flagship fit for the seam's fwd, dgrad and wgrad, the SR fits for the
    # carry-in forward and the downsample
    kernels = [{"name": f"up_conv_{k}", "route": "cuda", "source": src, "replaces": rep,
                "launches": (sr_launches if k == "fwd_carry" else launches)[k],
                "max_abs_err": stats[k]["max_abs_err"],
                "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"]}
               for k, (src, rep) in KERNELS.items()]
    kernels.append({"name": "downsample_fused", "route": "cuda", "source": DOWNSAMPLE[0],
                    "replaces": DOWNSAMPLE[1], "launches": sr_launches["downsample"],
                    "max_abs_err": down["max_abs_err"], "ms": down["ms"],
                    "plain_ms": down["plain_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
