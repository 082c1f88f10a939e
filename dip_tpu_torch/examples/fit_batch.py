"""Batched multi-image fitting: N independent denoising problems as one
program (BatchEngine: vmap over the images), split over the CUDA devices
when more than one divides the batch.

Fit i's z comes from seed + i and its weights and jitter from seed + i + 1
on, as eval-sr --fleet seeds its images.

Usage:
    python -m dip_tpu_torch.examples.fit_batch --batch 8 --size 256 --num-iter 500
"""

import argparse
import time

import numpy as np
import torch

from dip_tpu_torch.data.synthetic import SYNTHETIC_SET, synthetic_image
from dip_tpu_torch.fit.engine import FitConfig
from dip_tpu_torch.models import Skip
from dip_tpu_torch.ops.losses import mse, psnr
from dip_tpu_torch.parallel.batch import BatchEngine
from dip_tpu_torch.parallel.mesh import Mesh, make_mesh
from dip_tpu_torch.tasks.denoise import get_noisy_image
from dip_tpu_torch.utils.image_io import save_image
from dip_tpu_torch.utils.noise import get_noise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--num-iter", type=int, default=500)
    ap.add_argument("--sigma", type=float, default=25.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    n_dev = torch.cuda.device_count() if torch.device(args.device).type == "cuda" else 1
    use_all = n_dev > 1 and args.batch % n_dev == 0
    mesh = make_mesh() if use_all else Mesh([args.device])
    print(f"devices: {n_dev}, mesh: {'data:' + str(n_dev) if use_all else 'none'}")

    rng = np.random.default_rng(args.seed)
    imgs = np.stack([
        synthetic_image(SYNTHETIC_SET[i % len(SYNTHETIC_SET)], args.size)
        for i in range(args.batch)
    ])
    noisy = np.stack([get_noisy_image(im, args.sigma / 255, rng) for im in imgs])
    targets = torch.from_numpy(noisy[:, None])  # (B, 1, H, W, C)
    gts = torch.from_numpy(imgs[:, None])

    model = Skip(num_input_channels=32, num_channels_down=[128] * 5,
                 num_channels_up=[128] * 5, num_channels_skip=[4] * 5,
                 upsample_mode="bilinear", pad="reflection")
    cfg = FitConfig(num_iter=args.num_iter, lr=0.01, reg_noise_std=1 / 30,
                    exp_weight=0.99, log_every=100)
    eng = BatchEngine(
        model, lambda p, o, a: mse(o, a), cfg,
        metrics_fn=lambda o, e, a: {"psnr_track": psnr(o, a)}, mesh=mesh,
    )

    zs = torch.stack([get_noise(torch.Generator().manual_seed(args.seed + i), 32, "noise",
                                (args.size, args.size), device="cpu")
                      for i in range(args.batch)])
    state = eng.init_state([args.seed + i + 1 for i in range(args.batch)], zs)

    t0 = time.time()
    state, hist = eng.run(state, targets,
                          callback=lambda it, h, s: print(
                              f"iter {it:5d}  mean loss {h['loss'][-1].mean():.6f}",
                              flush=True))
    dt = time.time() - t0
    outs = eng.render(state).cpu()
    for i in range(args.batch):
        p = float(psnr(outs[i], gts[i]))
        print(f"image {i} ({SYNTHETIC_SET[i % len(SYNTHETIC_SET)]}): {p:.2f} dB vs GT")
        save_image(f"batch_out_{i}.png", np.clip(outs[i, 0].numpy(), 0, 1))
    total = args.num_iter * args.batch
    print(f"{total} image-iters in {dt:.1f}s = {total / dt:.1f} it/s aggregate")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
