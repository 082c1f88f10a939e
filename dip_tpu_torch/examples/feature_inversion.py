"""Feature inversion through a frozen classifier (parity: feature_inversion.ipynb).

Reconstructs an image whose deep features (default: AlexNet fc6) match the
content image's. Without a weights checkpoint the backbone is random-init —
pass --weights to a torch .pth for the real effect.

Usage:
    python -m dip_tpu_torch.examples.feature_inversion --image building.jpg \
        [--weights alexnet-torch_py3.pth] [--layers fc6]
"""

import argparse

import numpy as np

from dip_tpu_torch.tasks.base import run_task
from dip_tpu_torch.tasks.feature_inversion import FeatureInversion
from dip_tpu_torch.utils.image_io import get_image, hwc_to_nhwc, nhwc_to_hwc, save_image


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--backbone", default="alexnet_caffe",
                    choices=["alexnet_caffe", "vgg19_caffe", "vgg16_caffe"])
    ap.add_argument("--layers", default="fc6",
                    help="comma-separated tap names, e.g. 'fc6' or 'conv3,conv4'")
    ap.add_argument("--weights", default=None, help="torch checkpoint path")
    ap.add_argument("--num-iter", type=int, default=3100)
    ap.add_argument("--out", default="inverted.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    fi = FeatureInversion(
        backbone=args.backbone,
        layers=tuple(args.layers.split(",")),
        weights_path=args.weights,
        num_iter=args.num_iter,
        device=args.device,
    )
    _, content = get_image(args.image, fi.imsize)
    spec = fi.spec(hwc_to_nhwc(content))

    def cb(it, hist, state):
        print(f"iter {it:5d}  loss {hist['loss'][-1]:.4f}", flush=True)

    out, _, _ = run_task(spec, args.seed, device=args.device, callback=cb)
    save_image(args.out, np.clip(nhwc_to_hwc(out), 0, 1))
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
