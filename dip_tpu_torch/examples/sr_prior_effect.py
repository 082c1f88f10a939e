"""Prior-effect ablation (parity: sr_prior_effect.ipynb).

Compares x4 super-resolution with and without the architectural prior:
the skip generator versus no network at all (identity — optimize HR pixels
directly, OPT_OVER='input'). The quality gap between the two IS the deep
image prior.

Usage:
    python -m dip_tpu_torch.examples.sr_prior_effect --image zebra_GT.png --num-iter 1000
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
    ap.add_argument("--factor", type=int, default=4)
    ap.add_argument("--num-iter", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    imgs = super_resolve.load_lr_hr(args.image, -1, args.factor, "CROP")
    lr = hwc_to_nhwc(imgs["LR_np"])
    gt = hwc_to_nhwc(imgs["HR_np"])

    results = {}
    for net in ("skip", "identity"):
        spec = super_resolve.task(lr, factor=args.factor, hr_gt=gt,
                                  num_iter=args.num_iter, net=net)
        out, _, hist = run_task(spec, args.seed, device=args.device)
        pred = np.clip(nhwc_to_hwc(out), 0, 1)
        score = psnr_y_bbox_protocol(imgs["HR_np"], pred)
        results[net] = score
        save_image(f"prior_effect_{net}.png", pred)
        print(f"{net}: PSNR-Y {score:.3f} dB")

    print(f"prior effect: {results['skip'] - results['identity']:+.2f} dB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
