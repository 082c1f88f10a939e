"""Single-image super-resolution x4/x8 (parity: super-resolution.ipynb).

Usage:
    python -m dip_tpu_torch.examples.super_resolution --image zebra_GT.png --factor 4
"""

import argparse

import numpy as np

from dip_tpu_torch.eval.sr_eval import psnr_y_bbox_protocol
from dip_tpu_torch.tasks import super_resolve
from dip_tpu_torch.tasks.base import run_task
from dip_tpu_torch.utils.image_io import hwc_to_nhwc, nhwc_to_hwc, save_image


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True, help="HR ground-truth image")
    ap.add_argument("--factor", type=int, default=4, choices=[4, 8])
    ap.add_argument("--tv-weight", type=float, default=0.0)
    ap.add_argument("--num-iter", type=int, default=None)
    ap.add_argument("--net", default="skip", choices=["skip", "identity"],
                    help="'identity' = sr_prior_effect mode (optimize pixels)")
    ap.add_argument("--out", default="sr.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    imgs = super_resolve.load_lr_hr(args.image, -1, args.factor, "CROP")
    bicubic, sharp, nearest = super_resolve.get_baselines(
        imgs["LR_pil"], imgs["HR_pil"])
    print("bicubic baseline PSNR-Y:",
          psnr_y_bbox_protocol(imgs["HR_np"], bicubic))

    spec = super_resolve.task(
        hwc_to_nhwc(imgs["LR_np"]), factor=args.factor,
        hr_gt=hwc_to_nhwc(imgs["HR_np"]), tv_weight=args.tv_weight,
        num_iter=args.num_iter, net=args.net,
    )

    def cb(it, hist, state):
        print(f"iter {it:5d}  psnr_lr {hist['psnr_lr'][-1]:.2f}"
              f"  psnr_hr {hist['psnr_hr'][-1]:.2f}", flush=True)

    out, _, _ = run_task(spec, args.seed, device=args.device, callback=cb)
    pred = np.clip(nhwc_to_hwc(out), 0, 1)
    print("DIP PSNR-Y:", psnr_y_bbox_protocol(imgs["HR_np"], pred))
    save_image(args.out, pred)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
