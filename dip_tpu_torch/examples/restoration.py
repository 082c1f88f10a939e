"""Sparse restoration from a random pixel fraction (parity: restoration.ipynb).

Usage:
    python -m dip_tpu_torch.examples.restoration --image barbara.png --preset barbara
    python -m dip_tpu_torch.examples.restoration --image kate.png --preset kate
"""

import argparse

import numpy as np

from dip_tpu_torch.tasks import restore
from dip_tpu_torch.tasks.base import run_task
from dip_tpu_torch.utils.image_io import (crop_image, get_image, hwc_to_nhwc, nhwc_to_hwc,
                                          pil_to_np, save_image)
from dip_tpu_torch.utils.masks import get_bernoulli_mask


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--preset", default="barbara", choices=["barbara", "kate"])
    ap.add_argument("--num-iter", type=int, default=None)
    ap.add_argument("--out", default="restored.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    pil, _ = get_image(args.image, -1)
    img = pil_to_np(crop_image(pil, d=64))

    # barbara keeps 50% of pixels; kate keeps 2% (restoration.ipynb cells 5, 7)
    zero_fraction = 0.5 if args.preset == "barbara" else 0.98
    mask = get_bernoulli_mask(img.shape, zero_fraction,
                              np.random.default_rng(args.seed))

    # observation = img*mask; the clean image serves as GT for metrics
    spec = restore.task(hwc_to_nhwc(img * mask), hwc_to_nhwc(mask),
                        preset=args.preset, num_iter=args.num_iter,
                        gt=hwc_to_nhwc(img))

    def cb(it, hist, state):
        print(f"iter {it:5d}  loss {hist['loss'][-1]:.6f}"
              f"  psnr_full {hist['psnr_full'][-1]:.2f}", flush=True)

    out, _, _ = run_task(spec, args.seed, device=args.device, callback=cb)
    save_image(args.out, np.clip(nhwc_to_hwc(out), 0, 1))
    save_image("observed.png", img * mask)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
