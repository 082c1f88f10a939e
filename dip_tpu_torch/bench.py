"""Benchmark: DIP fit iterations/second on the flagship denoising workload,
on one CUDA device.

Counterpart of dip_tpu/bench.py's b1 rows: skip 128x5 generator, 512^2
synthetic noisy image, input depth 32, jitter 1/30, EMA 0.99, MSE and
on-device PSNR, no backtracking, timed over `iters` steps after one warm
chunk (best of 3). Rows carry the same JSON keys as the JAX bench plus
`device`, `power_limit` and `tf32`. There is no CPU fallback: without a
card it raises.

    python -m dip_tpu_torch.bench [--size 512] [--iters 100]
    python -m dip_tpu_torch.bench --profile 5   # kernel table per dtype
    python -m dip_tpu_torch.bench --profile 5 --fit kate [--conv-wgrad 3x3]

`--fit kate` profiles inpainting 'kate' (128-channel skips, nearest up,
masked MSE) on a synthetic image and mask of the same size in place of the
flagship; `--conv-wgrad` routes its conv weight gradients through the
port's kernels (the model's `conv_wgrad`, 'off' by default). The bf16 3x3
and 1x1 gradients (K5, K6) share `up_conv_wgrad_mma_kernel` and its sum
passes with the seam's (K3): the profile of the same fit with 'off' gives
K3's share. In f32 both run `wgrad_f32_kernel` and `wgrad_sum_kernel`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

REFERENCE_GPU_ESTIMATE_ITERS_PER_SEC = 10.0
# the kernels of dip_tpu_torch/csrc, as the profiler names them
PORT_KERNELS = ("up_conv_fwd_mma_kernel", "up_conv_dgrad_mma_kernel", "up_conv_dgrad_sum_kernel",
                "up_conv_wgrad_mma_kernel", "up_conv_wgrad_sum_kernel",
                "up_conv_wgrad_sum_rows_kernel", "s2d_pack_kernel",
                "wgrad_f32_kernel", "wgrad_sum_kernel",
                "downsample_kernel")
_BASELINE = Path(__file__).resolve().parents[1] / "results" / "torch_baseline.json"


def measured_torch_baseline() -> float:
    """it/s of the reference PyTorch loop on a CPU (results/torch_baseline.json)."""
    return float(json.loads(_BASELINE.read_text())["torch_it_per_s"])


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


def _kate(size: int, compute_dtype: str | None, device: str, conv_wgrad: str = "off"):
    """(engine, state, aux) of inpainting 'kate' on a CUDA device, its conv
    weight gradients routed as `conv_wgrad` says."""
    import dataclasses

    from dip_tpu_torch.fit.engine import Engine, resolve_device
    from dip_tpu_torch.tasks import inpaint
    from dip_tpu_torch.tasks.base import make_input, to_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench measures a CUDA device")
    img, mask = synthetic_inpaint(size)
    spec = inpaint.task(img * mask, mask, "kate", gt=img)
    spec.model.conv_wgrad = conv_wgrad
    cfg = dataclasses.replace(spec.cfg, compute_dtype=compute_dtype)
    eng = Engine(spec.model, spec.loss_fn, cfg, spec.metrics_fn, device=dev)
    state = eng.init_state(0, make_input(spec, torch.Generator().manual_seed(0), dev),
                           spec.extra_params)
    return eng, state, to_device(spec.aux, dev)


def _flagship(size: int, iters: int, compute_dtype: str | None, device: str):
    """(engine, state, target) of the flagship fit on a CUDA device."""
    from dip_tpu_torch.fit.engine import Engine, FitConfig, default_metrics, resolve_device
    from dip_tpu_torch.models import Skip
    from dip_tpu_torch.ops.losses import mse
    from dip_tpu_torch.utils.noise import get_noise

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the bench measures a CUDA device")
    model = Skip(num_input_channels=32, num_channels_down=[128] * 5,
                 num_channels_up=[128] * 5, num_channels_skip=[4] * 5,
                 upsample_mode="bilinear", pad="reflection")
    cfg = FitConfig(num_iter=iters, lr=0.01, reg_noise_std=1.0 / 30,
                    exp_weight=0.99, log_every=iters, compute_dtype=compute_dtype)
    target = torch.from_numpy(synthetic_noisy(size)[1]).to(dev)
    eng = Engine(model, lambda p, out, aux: mse(out, aux), cfg,
                 default_metrics(target), device=dev)
    z = get_noise(torch.Generator().manual_seed(1), 32, "noise", (size, size),
                  device=eng.device)
    return eng, eng.init_state(0, z), target


def run_bench(size: int = 512, iters: int = 100, compute_dtype: str | None = None,
              device: str = "cuda", print_json: bool = True) -> dict:
    eng, state, target = _flagship(size, iters, compute_dtype, device)

    def chunk():
        for _ in range(iters):
            eng.step(state, target)

    chunk()  # warm: cuDNN plans, the kernel build, the allocator
    torch.cuda.synchronize()
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        dt = min(dt, time.perf_counter() - t0)
    ips = iters / dt
    baseline = measured_torch_baseline()
    tag = "" if compute_dtype is None else f"_{compute_dtype}"
    result = {
        "metric": f"dip_iters_per_sec_{size}x{size}_b1{tag}",
        "value": round(ips, 2),
        "unit": "iters/s",
        "vs_baseline": round(ips / baseline, 1),
        "baseline_note": f"reference torch loop on a CPU: {baseline} it/s "
                         f"(results/torch_baseline.json)",
        "vs_ref_gpu_estimate": round(ips / REFERENCE_GPU_ESTIMATE_ITERS_PER_SEC, 2),
        "device": torch.cuda.get_device_name(eng.device),
        "power_limit": card_line().split(",")[-1].strip(),
        "tf32": eng.tf32,
    }
    if print_json:
        print(json.dumps(result), flush=True)
    return result


def run_full(size: int = 512, iters: int = 100, print_json: bool = True) -> dict:
    """b1 bf16 (the headline value) with the b1 f32 row as `b1_f32`."""
    r_bf16 = run_bench(size, iters, "bfloat16", print_json=print_json)
    r_f32 = run_bench(size, iters, None, print_json=print_json)
    result = dict(r_bf16, b1_f32=r_f32["value"])
    if print_json:
        print(json.dumps(result), flush=True)
    return result


def profile(size: int = 512, steps: int = 5, compute_dtype: str | None = None,
            device: str = "cuda", rows: int = 30, fit: str = "flagship",
            conv_wgrad: str = "off") -> dict:
    """torch.profiler over `steps` warm steps of the flagship (or of
    inpainting 'kate', with `conv_wgrad`): prints the kernels by device
    time, then each of the port's own kernels with its ms and launches a
    step, and returns the window's wall time, summed kernel time, the
    device's idle share (1 - kernel time / wall time) and the port's
    kernels."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    if fit == "kate":
        eng, state, target = _kate(size, compute_dtype, device, conv_wgrad)
    else:
        eng, state, target = _flagship(size, steps, compute_dtype, device)
    for _ in range(10):
        eng.step(state, target)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step(state, target)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    kernel_us = sum(e.self_device_time_total for e in avgs
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    tag = compute_dtype or "float32"
    what = f"{fit} {tag}" + (f" conv_wgrad={conv_wgrad}" if fit == "kate" else "")
    print(f"# profile {what}: {steps} steps, wall {wall * 1e3 / steps:.2f} ms/step, "
          f"kernels {kernel_us / 1e3 / steps:.2f} ms/step, device idle "
          f"{1 - kernel_us / 1e6 / wall:.3f} | {card_line()} | {eng.tf32}", flush=True)
    print(avgs.table(sort_by="self_device_time_total", row_limit=rows), flush=True)
    ours: dict[str, list[float]] = {}  # name: [ms, launches] a step, over template instances
    for e in avgs:
        name = next((k for k in PORT_KERNELS if f"::{k}<" in e.key or f"::{k}(" in e.key), None)
        if name is not None and e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = ours.setdefault(name, [0.0, 0.0])
            ours[name] = [ms + e.self_device_time_total / 1e3 / steps, n + e.count / steps]
    print(f"# port kernels {what} (ms, launches a step): " + ", ".join(
        f"{k} {ms:.4f} ({n:g})" for k, (ms, n) in ours.items()), flush=True)
    return {"fit": fit, "dtype": tag, "conv_wgrad": conv_wgrad,
            "wall_ms_per_step": wall * 1e3 / steps, "kernel_ms_per_step": kernel_us / 1e3 / steps,
            "device_idle": 1 - kernel_us / 1e6 / wall, "port_kernels": ours}


def main() -> None:
    from dip_tpu_torch.models.blocks import CONV_WGRAD

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--profile", type=int, default=0, metavar="STEPS",
                    help="instead of timing, profile STEPS steps per dtype")
    ap.add_argument("--fit", choices=("flagship", "kate"), default="flagship",
                    help="the fit --profile runs")
    ap.add_argument("--conv-wgrad", default="off", choices=CONV_WGRAD,
                    help="--fit kate: route these conv weight gradients through the kernels")
    args = ap.parse_args()
    if args.conv_wgrad != "off" and not (args.profile and args.fit == "kate"):
        ap.error("--conv-wgrad is an option of --profile with --fit kate")
    if args.profile:
        for cd in ("bfloat16", None):
            profile(args.size, args.profile, cd, fit=args.fit, conv_wgrad=args.conv_wgrad)
    else:
        run_full(args.size, args.iters)


if __name__ == "__main__":
    main()
