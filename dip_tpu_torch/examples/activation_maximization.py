"""Activation maximization (parity: activation_maximization.ipynb).

Synthesize an input that excites a chosen unit: a conv channel within a
center window, or a class logit at fc8.

Usage:
    python -m dip_tpu_torch.examples.activation_maximization --layer conv4 --map-idx 2
    python -m dip_tpu_torch.examples.activation_maximization --layer fc8 --map-idx 100 \
        [--weights alexnet-torch_py3.pth]
"""

import argparse

import numpy as np

from dip_tpu_torch.tasks import activation_maximization as am
from dip_tpu_torch.tasks.base import run_task
from dip_tpu_torch.utils.image_io import nhwc_to_hwc, save_image


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default="alexnet_caffe",
                    choices=["alexnet_caffe", "vgg19_caffe", "vgg16_caffe"])
    ap.add_argument("--layer", default="conv4")
    ap.add_argument("--map-idx", type=int, default=2)
    ap.add_argument("--window-size", type=int, default=20)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--tv-weight", type=float, default=0.0)
    ap.add_argument("--num-iter", type=int, default=3100)
    ap.add_argument("--out", default="activation_max.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    spec = am.task(
        backbone=args.backbone,
        layer=args.layer,
        map_idx=args.map_idx,
        window_size=args.window_size,
        weights_path=args.weights,
        tv_weight=args.tv_weight,
        num_iter=args.num_iter,
        device=args.device,
    )

    def cb(it, hist, state):
        print(f"iter {it:5d}  loss {hist['loss'][-1]:.4f}", flush=True)

    out, _, _ = run_task(spec, args.seed, device=args.device, callback=cb)
    save_image(args.out, np.clip(nhwc_to_hwc(out), 0, 1))
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
