"""Inpainting: text overlay / large-hole / sparse masks (parity: inpainting.ipynb).

Usage:
    python -m dip_tpu_torch.examples.inpainting --image kate.png --mask text --preset kate
    python -m dip_tpu_torch.examples.inpainting --image vase.png --mask vase_mask.png \
        --preset vase
    python -m dip_tpu_torch.examples.inpainting --image library.png \
        --mask library_mask.png --preset library --net skip_depth6
"""

import argparse

import numpy as np

from dip_tpu_torch.tasks import inpaint
from dip_tpu_torch.tasks.base import run_task
from dip_tpu_torch.utils.image_io import (crop_image, get_image, hwc_to_nhwc, nhwc_to_hwc,
                                          pil_to_np, save_image)
from dip_tpu_torch.utils.masks import get_bernoulli_mask, get_text_mask


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--mask", default="text",
                    help="path | 'text' | 'bernoulli:FRACTION'")
    ap.add_argument("--preset", default="kate",
                    choices=["kate", "vase", "library"])
    ap.add_argument("--net", default="skip", help="library preset: skip_depthN | UNet | ResNet")
    ap.add_argument("--num-iter", type=int, default=None)
    ap.add_argument("--out", default="inpainted.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    pil, _ = get_image(args.image, -1)
    img = pil_to_np(crop_image(pil, d=64))

    if args.mask == "text":
        mask = get_text_mask(img.shape)
    elif args.mask.startswith("bernoulli:"):
        mask = get_bernoulli_mask(img.shape, float(args.mask.split(":")[1]))
    else:
        mpil, _ = get_image(args.mask, -1)
        mask = pil_to_np(crop_image(mpil, d=64))

    spec = inpaint.task(hwc_to_nhwc(img), hwc_to_nhwc(mask),
                        preset=args.preset, gt=hwc_to_nhwc(img),
                        num_iter=args.num_iter, net_type=args.net)

    def cb(it, hist, state):
        print(f"iter {it:5d}  loss {hist['loss'][-1]:.6f}", flush=True)

    out, _, _ = run_task(spec, args.seed, device=args.device, callback=cb)
    save_image(args.out, np.clip(nhwc_to_hwc(out), 0, 1))
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
