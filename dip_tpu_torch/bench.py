"""Benchmark: DIP fit iterations/second on the flagship denoising workload,
on one CUDA device.

Counterpart of dip_tpu/bench.py: skip 128x5 generator, 512^2 synthetic
noisy image, input depth 32, jitter 1/30, EMA 0.99, MSE and on-device PSNR,
no backtracking. The b1 rows time the graphed chunk (`iters` replays of
the step's CUDA graph, Engine.run_chunk: the JAX bench's compiled chunk)
after a warm chunk, best of 3, each beside its eager figure (`iters`
Engine.step calls), timed in turns with it. The b8 row runs 8 fits in bf16
through FitQueue, `log_every = iters`, from fresh jobs after a warm run,
each job's first (eager) step and capture inside the timer and its init
outside; its rate is iters x 8 / wall, and it checks that the 8 fits,
seeded apart, end with different params. `run_batch` (the CLI's `bench
--batch N` where there are several CUDA devices) runs the batch through
BatchEngine over the device mesh instead: one vmapped program per device.
Rows carry `metric`, `value` and `unit` (as the JAX bench's) with
`eager`, `device`, `power_limit` and `tf32`. There is no CPU fallback:
without a card it raises.

    python -m dip_tpu_torch.bench [--size 512] [--iters 100]
    python -m dip_tpu_torch.bench --profile 5   # kernel tables per dtype
    python -m dip_tpu_torch.bench --profile 5 --fit kate [--conv-wgrad 3x3]
    python -m dip_tpu_torch.bench --profile 5 --fit library-unet --conv-wgrad all
    python -m dip_tpu_torch.bench --profile 5 --fit am-alexnet
    python -m dip_tpu_torch.bench --profile 5 --fit flagship-lanczos2 --blocks 4

`--profile` profiles a graphed chunk and then as many eager steps with
the port's spans on (`dip.<layer>.<what>`, utils/profiling.py), and
prints each window's wall and kernel ms a step and the device's idle
share (one minus the union of the device operations' intervals over the
wall time). `--fit kate` profiles inpainting 'kate' (128-channel skips, nearest
up, masked MSE) on a synthetic image and mask of the same size in place of
the flagship, `--fit library-unet` and `library-resnet` inpainting
'library' with its UNet or its ResNet, `--fit fi-alexnet` feature
inversion at AlexNet fc6 and `am-alexnet` activation maximization at
AlexNet conv4 (227^2 under a generator at 256^2, whatever --size says),
`--fit flagship-lanczos2` the flagship with the lanczos2 post-down in
place of its stride-2 convs; `--blocks N` profiles a flagship fit over N
row blocks on the one card (parallel/spatial.py's SpatialEngine);
`--conv-wgrad` routes their conv
weight gradients through the port's kernels (the model's `conv_wgrad`,
'off' by default). The bf16 3x3
and 1x1 gradients (K5, K6) share `up_conv_wgrad_mma_kernel` and its sum
passes with the seam's (K3): the profile of the same fit with 'off' gives
K3's share. In f32 both run `wgrad_f32_kernel` and `wgrad_sum_kernel`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from dip_tpu_torch.utils import profiling

# the kernels of dip_tpu_torch/csrc, as the profiler names them
PORT_KERNELS = ("up_conv_fwd_mma_kernel", "up_conv_dgrad_mma_kernel", "up_conv_dgrad_sum_kernel",
                "up_conv_wgrad_mma_kernel", "up_conv_wgrad_sum_kernel",
                "up_conv_wgrad_sum_rows_kernel", "s2d_pack_kernel",
                "wgrad_f32_kernel", "wgrad_sum_kernel",
                "downsample_kernel")
# the profile's kernel kinds, by substrings of the kernel's name, first match
# wins (the port's kernels are PORT_KERNELS)
KERNEL_KINDS = (("cuDNN/cuBLAS", ("cudnn", "xmma", "cutlass", "gemm", "convolve", "Nhwc", "Nchw")),
                ("optimizer", ("multi_tensor_apply",)),
                ("elementwise", ("elementwise",)),
                ("reductions", ("reduce_kernel",)))


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def synthetic_noisy(size: int) -> tuple[np.ndarray, np.ndarray]:
    """(clean, noisy) (1, size, size, 3) float32, sigma 25/255, seed 0."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    clean = np.stack([np.sin(xx / 23) * 0.5 + 0.5,
                      np.cos(yy / 17) * 0.5 + 0.5,
                      (xx + yy) / (2 * size)], axis=-1)
    noisy = np.clip(clean + rng.normal(scale=25 / 255.0, size=clean.shape), 0, 1)
    return clean[None].astype(np.float32), noisy[None].astype(np.float32)


def synthetic_inpaint(size: int) -> tuple[np.ndarray, np.ndarray]:
    """(image, mask): a (1, size, size, 3) smooth image with texture, made
    with numpy, and a text-like mask of its own: rows of small zeroed
    blocks, as a line of glyphs would be (Pillow, which draws the recipe's
    text mask, is not needed here; the CPU tests cover the text mask)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.stack([np.sin(xx / 21) * np.cos(yy / 29) * 0.5 + 0.5,
                    np.cos((xx - yy) / 17) * 0.4 + 0.5,
                    np.sin(xx / 7) * np.sin(yy / 9) * 0.2 + (xx + yy) / (4 * size) + 0.3],
                   axis=-1)
    img = np.clip(img + np.random.default_rng(1).random(img.shape) * 0.05, 0, 1)
    mask = np.ones((size, size, 3), np.float32)
    rng = np.random.default_rng(2)
    for y0 in range(size // 8, size - size // 8, size // 8):
        for x0 in range(size // 16, size - size // 16, 14):
            if rng.random() < 0.7:
                mask[y0:y0 + 12, x0:x0 + 3 + int(rng.integers(0, 8))] = 0
    return img[None].astype(np.float32), mask[None]


def _cuda(device: str) -> torch.device:
    from dip_tpu_torch.fit.engine import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench measures a CUDA device")
    return dev


# the inpainting fits --profile runs: fit -> (preset, net_type)
MASKED_FITS = {"kate": ("kate", "skip"), "library-unet": ("library", "UNet"),
               "library-resnet": ("library", "ResNet")}


def _kate(size: int, compute_dtype: str | None, device: str, conv_wgrad: str = "off",
          steps: int = 100, fit: str = "kate"):
    """(engine, state, aux) of inpainting 'kate' (or of the inpainting fit
    `fit` of MASKED_FITS) on a CUDA device, its conv weight gradients routed
    as `conv_wgrad` says, in chunks of `steps`. seam_times.py imports it
    from either checkout it compares."""
    import dataclasses

    from dip_tpu_torch.tasks import inpaint
    from dip_tpu_torch.tasks.base import start_task

    preset, net_type = MASKED_FITS[fit]
    img, mask = synthetic_inpaint(size)
    spec = inpaint.task(img * mask, mask, preset, gt=img, net_type=net_type)
    spec.model.conv_wgrad = conv_wgrad
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, compute_dtype=compute_dtype, log_every=steps))
    return start_task(spec, 0, device=_cuda(device))


# the feature-inversion and activation-maximization fits --profile runs, at
# their recipes' sizes: AlexNet at 227^2 under the inversion net at 256^2
PRETRAINED_FITS = ("fi-alexnet", "am-alexnet")


def _pretrained(fit: str, compute_dtype: str | None, device: str, steps: int):
    """(engine, state, aux) of feature inversion at AlexNet fc6 (a
    synthetic content image) or activation maximization at AlexNet conv4
    map 2, seeded random backbone weights, on a CUDA device, in chunks of
    `steps`."""
    import dataclasses

    from dip_tpu_torch.tasks.base import start_task

    dev = _cuda(device)
    if fit == "fi-alexnet":
        from dip_tpu_torch.data import synthetic_image
        from dip_tpu_torch.tasks import feature_inversion

        fi = feature_inversion.FeatureInversion(device=dev)
        spec = fi.spec(synthetic_image("disks", fi.imsize)[None])
    else:
        from dip_tpu_torch.tasks import activation_maximization

        spec = activation_maximization.task(device=dev)
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(
        spec.cfg, compute_dtype=compute_dtype, log_every=steps))
    return start_task(spec, 0, device=dev)


def flagship_spec(size: int, iters: int, compute_dtype: str | None, target: torch.Tensor,
                  downsample_mode: str = "stride"):
    """The flagship fit as a TaskSpec of `iters` steps in one chunk, fitting
    `target` (on the fit's device); `downsample_mode` the Skip's."""
    from dip_tpu_torch.fit.engine import FitConfig, default_metrics
    from dip_tpu_torch.models import Skip
    from dip_tpu_torch.ops.losses import mse
    from dip_tpu_torch.tasks.base import TaskSpec

    model = Skip(num_input_channels=32, num_channels_down=[128] * 5,
                 num_channels_up=[128] * 5, num_channels_skip=[4] * 5,
                 upsample_mode="bilinear", pad="reflection", downsample_mode=downsample_mode)
    cfg = FitConfig(num_iter=iters, lr=0.01, reg_noise_std=1.0 / 30,
                    exp_weight=0.99, log_every=iters, compute_dtype=compute_dtype)
    return TaskSpec(name="flagship", model=model, cfg=cfg,
                    loss_fn=lambda p, out, aux: mse(out, aux), aux=target,
                    metrics_fn=default_metrics(target), input_depth=32,
                    spatial_size=(size, size))


def _flagship(size: int, iters: int, compute_dtype: str | None, device: str,
              downsample_mode: str = "stride", blocks: int = 0):
    """(engine, state, target) of the flagship fit on a CUDA device: weights
    from seed 0, z from seed 1; with `blocks`, a SpatialEngine over that
    many row blocks on the one device."""
    from dip_tpu_torch.fit.engine import Engine
    from dip_tpu_torch.parallel.mesh import Mesh
    from dip_tpu_torch.parallel.spatial import SpatialEngine
    from dip_tpu_torch.utils.noise import get_noise

    dev = _cuda(device)
    target = torch.from_numpy(synthetic_noisy(size)[1]).to(dev)
    spec = flagship_spec(size, iters, compute_dtype, target, downsample_mode)
    if blocks:
        eng = SpatialEngine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn,
                            mesh=Mesh([dev] * blocks, axis="sp"))
    else:
        eng = Engine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn, device=dev)
    z = get_noise(torch.Generator().manual_seed(1), 32, "noise", (size, size),
                  device=eng.device)
    return eng, eng.init_state(0, z), target


def _row(metric: str, ips: float, dev: torch.device, tf32: dict) -> dict:
    return {
        "metric": metric,
        "value": round(ips, 2),
        "unit": "iters/s",
        "device": torch.cuda.get_device_name(dev),
        "power_limit": card_line().split(",")[-1].strip(),
        "tf32": tf32,
    }


def run_bench(size: int = 512, iters: int = 100, compute_dtype: str | None = None,
              device: str = "cuda", print_json: bool = True) -> dict:
    """The b1 row: the graphed chunk's it/s (`value`) and the eager steps'
    (`eager`), best of 3, timed in turns on one fit."""
    eng, state, target = _flagship(size, iters, compute_dtype, device)

    def graphed():
        eng.run_chunk(state, target, iters)
        eng.wait()

    def eager():
        for _ in range(iters):
            eng.step(state, target)

    # warm: the capture (after one eager step), cuDNN plans, the kernel build
    graphed()
    eager()
    best = {graphed: float("inf"), eager: float("inf")}
    for turn in ((graphed, eager), (eager, graphed), (graphed, eager)):
        for fn in turn:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best[fn] = min(best[fn], time.perf_counter() - t0)
    tag = "" if compute_dtype is None else f"_{compute_dtype}"
    result = _row(f"dip_iters_per_sec_{size}x{size}_b1{tag}", iters / best[graphed],
                  eng.device, eng.tf32)
    result["eager"] = round(iters / best[eager], 2)
    if print_json:
        print(json.dumps(result), flush=True)
    return result


def run_queue(size: int = 512, iters: int = 100, batch: int = 8,
              compute_dtype: str | None = "bfloat16", device: str = "cuda",
              print_json: bool = True) -> dict:
    """The b{batch} row: `batch` flagship fits through FitQueue, one chunk
    of `iters` each, fresh jobs (seeds batch..2*batch-1) after a warm run;
    raises unless their final params differ pairwise."""
    from dip_tpu_torch.fit.engine import tf32_flags
    from dip_tpu_torch.parallel import FitQueue

    dev = _cuda(device)
    spec = flagship_spec(size, iters, compute_dtype,
                         torch.from_numpy(synthetic_noisy(size)[1]).to(dev))

    def queue(seed0: int) -> FitQueue:
        q = FitQueue()
        for i in range(batch):
            q.add(spec, seed0 + i, name=f"img{i}", device=dev)
        return q

    queue(0).run()  # warm: cuDNN plans, the kernel build
    q = queue(batch)  # fresh jobs, init outside the timer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = q.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    first = next(iter(spec.model.state_dict()))
    weights = [r[1].params[first] for r in res.values()]
    if any(torch.equal(weights[i], weights[j]) for i in range(batch) for j in range(i)):
        raise RuntimeError("fits seeded apart ended with equal params")
    tag = "" if compute_dtype is None else f"_{compute_dtype}"
    result = _row(f"dip_iters_per_sec_{size}x{size}_b{batch}{tag}", iters * batch / dt,
                  dev, tf32_flags())
    if print_json:
        print(json.dumps(result), flush=True)
    return result


def run_batch(size: int = 512, iters: int = 100, batch: int = 8,
              compute_dtype: str | None = "bfloat16", mesh=None,
              print_json: bool = True) -> dict:
    """The b{batch} row through BatchEngine over `mesh` (every CUDA device by
    default): one vmapped program per device, `batch` flagship fits (seeds
    0..batch-1) on the same target; a warm run of `iters` steps (the eager
    step and the capture), then `iters` more timed; its rate is iters x
    batch / wall."""
    from dip_tpu_torch.fit.engine import tf32_flags
    from dip_tpu_torch.ops.losses import mse, psnr
    from dip_tpu_torch.parallel import BatchEngine, make_mesh
    from dip_tpu_torch.tasks.base import make_input

    mesh = make_mesh() if mesh is None else mesh
    spec = flagship_spec(size, iters, compute_dtype, torch.zeros(()))
    # the target comes through aux (one per fit), so each device reads its own
    beng = BatchEngine(spec.model, lambda p, out, aux: mse(out, aux), spec.cfg,
                       lambda out, ema, aux: {"psnr_track": psnr(out, aux)}, mesh=mesh)
    target = torch.from_numpy(synthetic_noisy(size)[1])
    auxs = target.expand(batch, *target.shape).contiguous()
    zs = torch.stack([make_input(spec, torch.Generator().manual_seed(batch + i), "cpu")
                      for i in range(batch)])
    state = beng.init_state(range(batch), zs)
    beng.run(state, auxs)  # warm: the eager step, the capture, cuDNN plans
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    beng.run(state, auxs)
    for d in mesh.devices:
        torch.cuda.synchronize(d)
    dt = time.perf_counter() - t0
    tag = "" if compute_dtype is None else f"_{compute_dtype}"
    result = _row(f"dip_iters_per_sec_{size}x{size}_b{batch}{tag}", iters * batch / dt,
                  mesh.devices[0], tf32_flags())
    result["batch_engine_devices"] = mesh.size
    if print_json:
        print(json.dumps(result), flush=True)
    return result


def run_full(size: int = 512, iters: int = 100, batch: int = 8,
             print_json: bool = True) -> dict:
    """b1 bf16 (the headline value, its eager figure as `eager`) with
    `b1_f32`, `b1_f32_eager` and `b{batch}_queue_aggregate`, each row
    printed as it completes and then combined in one line."""
    r_bf16 = run_bench(size, iters, "bfloat16", print_json=print_json)
    r_f32 = run_bench(size, iters, None, print_json=print_json)
    r_queue = run_queue(size, iters, batch, "bfloat16", print_json=print_json)
    result = dict(r_bf16, b1_f32=r_f32["value"], b1_f32_eager=r_f32["eager"],
                  b_queue=batch)
    result[f"b{batch}_queue_aggregate"] = r_queue["value"]
    if print_json:
        print(json.dumps(result), flush=True)
    return result


def _busy_us(prof) -> float:
    """Microseconds in which at least one device operation runs (the union
    of their intervals: operations that overlap on streams count once)."""
    cuda = torch.autograd.DeviceType.CUDA
    ivs = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == cuda and not e.is_user_annotation)
    busy, end = 0.0, float("-inf")
    for a, b in ivs:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def _profile_window(prof_steps, steps: int, what: str, eng) -> dict:
    """torch.profiler over prof_steps(), the port's spans on: the kernels
    by device time, each of the port's own kernels with its ms and launches
    a step, and the kernel time a step by kind (KERNEL_KINDS); returns the
    window's wall time, summed kernel time, the device's idle share (1 -
    the union of the device operations' intervals / wall time), the port's
    kernels and the kinds."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            profiling.tracing():
        t0 = time.perf_counter()
        prof_steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device rows, less the user annotations that also land on the device's
    # timeline (the port's spans; Optimizer.step#Adam.step spans the step)
    avgs = prof.key_averages()
    device = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]
    kernel_us = sum(e.self_device_time_total for e in device)
    idle = 1 - _busy_us(prof) / 1e6 / wall
    print(f"# profile {what}: {steps} steps, wall {wall * 1e3 / steps:.2f} ms/step, "
          f"kernels {kernel_us / 1e3 / steps:.2f} ms/step, device idle "
          f"{idle:.3f} | {card_line()} | {eng.tf32}", flush=True)
    print(avgs.table(sort_by="self_device_time_total", row_limit=30), flush=True)
    ours: dict[str, list[float]] = {}  # name: [ms, launches] a step, over template instances
    kinds = dict.fromkeys(["port", *(k for k, _ in KERNEL_KINDS), "other"], 0.0)  # ms a step
    for e in device:
        ms_step = e.self_device_time_total / 1e3 / steps
        name = next((k for k in PORT_KERNELS if f"::{k}<" in e.key or f"::{k}(" in e.key), None)
        if name is not None:
            ms, n = ours.setdefault(name, [0.0, 0.0])
            ours[name] = [ms + ms_step, n + e.count / steps]
            kinds["port"] += ms_step
        else:
            kind = next((k for k, subs in KERNEL_KINDS if any(t in e.key for t in subs)), "other")
            kinds[kind] += ms_step
    print(f"# port kernels {what} (ms, launches a step): " + ", ".join(
        f"{k} {ms:.4f} ({n:g})" for k, (ms, n) in ours.items()), flush=True)
    print(f"# kernel kinds {what} (ms a step): " + ", ".join(
        f"{k} {ms:.2f}" for k, ms in kinds.items()), flush=True)
    return {"wall_ms_per_step": wall * 1e3 / steps, "kernel_ms_per_step": kernel_us / 1e3 / steps,
            "device_idle": idle, "port_kernels": ours, "kinds": kinds}


def profile(size: int = 512, steps: int = 5, compute_dtype: str | None = None,
            device: str = "cuda", fit: str = "flagship", conv_wgrad: str = "off",
            blocks: int = 0) -> dict:
    """The flagship (or its lanczos2 form, either over `blocks` row blocks
    with `blocks`; or an inpainting fit of MASKED_FITS, with `conv_wgrad`,
    or a fit of PRETRAINED_FITS at its recipe's size) under torch.profiler
    with the port's spans on (profiling.tracing), after a warm chunk and 10
    warm eager steps: a graphed chunk of `steps` replays, then `steps`
    eager steps."""
    if fit in MASKED_FITS:
        eng, state, target = _kate(size, compute_dtype, device, conv_wgrad, steps, fit)
    elif fit in PRETRAINED_FITS:
        eng, state, target = _pretrained(fit, compute_dtype, device, steps)
    else:
        eng, state, target = _flagship(size, steps, compute_dtype, device,
                                       "lanczos2" if fit == "flagship-lanczos2" else "stride",
                                       blocks)

    def graphed():
        eng.run_chunk(state, target, steps)
        eng.wait()

    def eager():
        for _ in range(steps):
            eng.step(state, target)

    graphed()  # the capture
    for _ in range(10):
        eng.step(state, target)
    tag = compute_dtype or "float32"
    what = (f"{fit} {tag}" + (f" conv_wgrad={conv_wgrad}" if fit in MASKED_FITS else "")
            + (f" over {blocks} row blocks" if blocks else ""))
    out = {"fit": fit, "dtype": tag, "conv_wgrad": conv_wgrad, "blocks": blocks}
    for mode, fn in (("graphed", graphed), ("eager", eager)):
        out[mode] = _profile_window(fn, steps, f"{what} {mode}", eng)
    return out


def main() -> None:
    from dip_tpu_torch.models.blocks import CONV_WGRAD

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="instead of timing, profile STEPS steps per dtype")
    ap.add_argument("--fit", choices=("flagship", "flagship-lanczos2", *MASKED_FITS,
                                      *PRETRAINED_FITS),
                    default="flagship", help="the fit --profile runs")
    ap.add_argument("--blocks", type=int, default=0,
                    help="--profile a flagship --fit over this many row blocks on the card "
                         "(SpatialEngine)")
    ap.add_argument("--conv-wgrad", default="off", choices=CONV_WGRAD,
                    help="an inpainting --fit: route these conv weight gradients through "
                         "the kernels")
    args = ap.parse_args()
    if args.conv_wgrad != "off" and not (args.profile and args.fit in MASKED_FITS):
        ap.error("--conv-wgrad is an option of --profile with an inpainting --fit")
    if args.blocks and not (args.profile and args.fit.startswith("flagship")):
        ap.error("--blocks is an option of --profile with a flagship --fit")
    if args.profile:
        for cd in ("bfloat16", None):
            profile(args.size, args.profile, cd, fit=args.fit, conv_wgrad=args.conv_wgrad,
                    blocks=args.blocks)
    else:
        run_full(args.size, args.iters)


if __name__ == "__main__":
    main()
