"""Blind denoising / JPEG-artifact removal (parity: denoising.ipynb).

Usage:
    python -m dip_tpu_torch.examples.denoising --image path/to/F16_GT.png --sigma 25
    python -m dip_tpu_torch.examples.denoising --image snail.jpg --preset snail --sigma 0
"""

import argparse
import time

import numpy as np

from dip_tpu_torch.tasks import denoise
from dip_tpu_torch.tasks.base import run_task
from dip_tpu_torch.utils.image_io import (crop_image, get_image, hwc_to_nhwc, nhwc_to_hwc,
                                          pil_to_np, save_image)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--preset", default="f16", choices=["f16", "snail"])
    ap.add_argument("--sigma", type=float, default=25.0,
                    help="noise std (0..255); 0 = the image is already degraded")
    ap.add_argument("--num-iter", type=int, default=None)
    ap.add_argument("--out", default="denoised.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    pil, _ = get_image(args.image, -1)
    img = pil_to_np(crop_image(pil, d=32))

    if args.sigma > 0:
        noisy = denoise.get_noisy_image(img, args.sigma / 255.0)
        gt = hwc_to_nhwc(img)
    else:
        noisy, gt = img, None

    spec = denoise.task(hwc_to_nhwc(noisy), preset=args.preset, gt=gt,
                        num_iter=args.num_iter)

    def cb(it, hist, state):
        line = f"iter {it:5d}  loss {hist['loss'][-1]:.6f}  psnr_noisy {hist['psnr_track'][-1]:.2f}"
        if "psnr_gt" in hist:
            line += f"  psnr_gt {hist['psnr_gt'][-1]:.2f}  psnr_gt_sm {hist['psnr_gt_sm'][-1]:.2f}"
        print(line, flush=True)

    t0 = time.time()
    out, state, hist = run_task(spec, args.seed, device=args.device, callback=cb)
    print(f"{spec.cfg.num_iter} iters in {time.time()-t0:.1f}s")
    save_image(args.out, np.clip(nhwc_to_hwc(out), 0, 1))
    # the EMA-smoothed output is usually the better restoration
    save_image(args.out.replace(".png", "_ema.png"),
               np.clip(nhwc_to_hwc(state.ema_out), 0, 1))
    print(f"saved {args.out} (+ _ema variant)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
