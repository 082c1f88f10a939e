"""Flash/no-flash reconstruction (parity: flash-no-flash.ipynb).

The flash image is the network input; the loss targets the no-flash image.

Usage:
    python -m dip_tpu_torch.examples.flash_no_flash --flash cave01_00_flash.jpg \
        --noflash cave01_01_noflash.jpg
"""

import argparse

import numpy as np

from dip_tpu_torch.tasks import flash_no_flash
from dip_tpu_torch.tasks.base import run_task
from dip_tpu_torch.utils.image_io import (crop_image, get_image, hwc_to_nhwc, nhwc_to_hwc,
                                          pil_to_np, save_image)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--flash", required=True)
    ap.add_argument("--noflash", required=True)
    ap.add_argument("--num-iter", type=int, default=601)
    ap.add_argument("--out", default="flash_no_flash.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    fpil, _ = get_image(args.flash, -1)
    npil, _ = get_image(args.noflash, -1)
    flash = pil_to_np(crop_image(fpil, d=64))
    noflash = pil_to_np(crop_image(npil, d=64))

    spec = flash_no_flash.task(hwc_to_nhwc(flash), hwc_to_nhwc(noflash),
                               num_iter=args.num_iter)

    def cb(it, hist, state):
        print(f"iter {it:5d}  loss {hist['loss'][-1]:.6f}", flush=True)

    out, _, _ = run_task(spec, args.seed, device=args.device, callback=cb)
    save_image(args.out, np.clip(nhwc_to_hwc(out), 0, 1))
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
