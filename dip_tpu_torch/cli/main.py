"""Command-line interface of the port (counterpart of dip_tpu/cli/main.py),
the same subcommands, flags and seven tasks, with the notebook recipes as
presets:

    python -m dip_tpu_torch fit --task denoise --image f16.png --sigma 25 --out d.png
    python -m dip_tpu_torch fit --task inpaint --image kate.png --mask text --preset kate
    python -m dip_tpu_torch fit --task sr --image zebra.png --factor 4
    python -m dip_tpu_torch fit --task flash_no_flash --image flash.png --mask noflash.png
    python -m dip_tpu_torch fit --task activation_max --layer fc8 --map-idx 340
    python -m dip_tpu_torch bench --size 512 --iters 100
    python -m dip_tpu_torch eval-sr --dir Set14/ --factor 4 [--fleet]

`--device` (default cuda) names the device the fits run on; without a
CUDA device, pass `--device cpu`. `eval-sr --fleet` runs the sharded
evaluation (same-shape images as one BatchEngine program per device) over
every CUDA device, or over a one-entry mesh of `--device` when that is not
'cuda'; `bench --batch N` runs BatchEngine over the devices where there
are several, else FitQueue. The JAX package's `--resample-impl` (its
downsampler layout switch) is refused. Pillow is imported only where an
image is read or written, PyYAML only for `--config`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

_NOT_PORTED = {
    "resample_impl": "--resample-impl selects the JAX package's in-graph downsampler; the "
                     "port has no such switch (its downsample runs the CUDA kernel on a CUDA "
                     "tensor and the plain version on a CPU tensor)",
}


def _load(path, d=32):
    from dip_tpu_torch.utils.image_io import crop_image, load_image, pil_to_np

    return pil_to_np(crop_image(load_image(path), d=d))


def _classifier_size(args) -> int:
    from dip_tpu_torch.pretrained.backbones import default_imsize

    return args.imsize or default_imsize(args.backbone)


def _build_spec(args, image):
    """One TaskSpec for one input image path (the per-image body of `fit`)."""
    from dip_tpu_torch.utils.image_io import hwc_to_nhwc

    if args.task == "denoise":
        from dip_tpu_torch.tasks import denoise

        img = _load(image)
        if args.sigma > 0:
            noisy = denoise.get_noisy_image(img, args.sigma / 255.0)
            gt = hwc_to_nhwc(img)
        else:
            noisy, gt = img, None
        spec = denoise.task(hwc_to_nhwc(noisy), preset=args.preset or "f16",
                            gt=gt, num_iter=args.num_iter)
    elif args.task == "inpaint":
        from dip_tpu_torch.tasks import inpaint
        from dip_tpu_torch.utils.masks import get_bernoulli_mask, get_text_mask

        img = _load(image, d=64)
        if args.mask == "text":
            mask = get_text_mask(img.shape)
        elif args.mask.startswith("bernoulli:"):
            frac = float(args.mask.split(":")[1])
            mask = get_bernoulli_mask(img.shape, zero_fraction=frac)
        else:
            mask = _load(args.mask, d=64)
        # the loaded image is the clean ground truth (the mask only enters
        # the loss), so full-image PSNR against it is meaningful
        spec = inpaint.task(hwc_to_nhwc(img), hwc_to_nhwc(mask),
                            preset=args.preset or "kate", gt=hwc_to_nhwc(img),
                            num_iter=args.num_iter)
    elif args.task == "restore":
        from dip_tpu_torch.tasks import restore
        from dip_tpu_torch.utils.masks import get_bernoulli_mask

        img = _load(image, d=64)
        frac = 0.5 if (args.preset or "barbara") == "barbara" else 0.98
        mask = get_bernoulli_mask(img.shape, zero_fraction=frac)
        spec = restore.task(hwc_to_nhwc(img * mask), hwc_to_nhwc(mask),
                            preset=args.preset or "barbara",
                            num_iter=args.num_iter, gt=hwc_to_nhwc(img))
    elif args.task == "sr":
        from dip_tpu_torch.tasks import super_resolve

        imgs = super_resolve.load_lr_hr(image, -1, args.factor, "CROP")
        spec = super_resolve.task(hwc_to_nhwc(imgs["LR_np"]), factor=args.factor,
                                  hr_gt=hwc_to_nhwc(imgs["HR_np"]),
                                  num_iter=args.num_iter)
    elif args.task == "flash_no_flash":
        from dip_tpu_torch.tasks import flash_no_flash

        flash = _load(image)
        noflash = _load(args.mask)  # --mask doubles as the second input
        spec = flash_no_flash.task(hwc_to_nhwc(flash), hwc_to_nhwc(noflash),
                                   num_iter=args.num_iter or 601)
    elif args.task == "feature_inversion":
        from dip_tpu_torch.tasks import feature_inversion
        from dip_tpu_torch.utils.image_io import load_image, pil_to_np

        layers = tuple(args.layer.split(",")) if args.layer else ("fc6",)
        imsize = _classifier_size(args)
        pil = load_image(image).resize((imsize, imsize))
        spec = feature_inversion.task(
            hwc_to_nhwc(pil_to_np(pil)), backbone=args.backbone,
            layers=layers, weights_path=args.weights, imsize=imsize,
            imsize_net=-(-imsize // 64) * 64,  # the net runs at the next /64 size
            num_iter=args.num_iter or 3100, device=args.device)
    elif args.task == "activation_max":
        from dip_tpu_torch.data.imagenet_classes import resolve_class
        from dip_tpu_torch.tasks import activation_maximization

        layer = args.layer or "conv4"
        if layer in ("fc6", "fc7", "fc8", "softmax"):
            idx, label = resolve_class(args.map_idx, args.class_map)
            print(f"maximizing {layer}[{idx}] = {label!r}")
        else:
            idx = int(args.map_idx)
        imsize = _classifier_size(args)
        spec = activation_maximization.task(
            backbone=args.backbone, layer=layer, map_idx=idx,
            window_size=args.window_size, weights_path=args.weights,
            imsize=imsize, imsize_net=-(-imsize // 64) * 64,
            num_iter=args.num_iter or 3100, device=args.device)
    else:
        raise SystemExit(f"unknown task {args.task!r}")

    updates = {}
    if args.log_every:
        updates["log_every"] = args.log_every
    if args.compute_dtype:
        updates["compute_dtype"] = None if args.compute_dtype == "f32" else args.compute_dtype
    if updates:
        spec.cfg = dataclasses.replace(spec.cfg, **updates)
    return spec


def _hist_line(prefix, it, hist):
    msg = f"{prefix}iter {it:5d}  loss {hist['loss'][-1]:.6f}"
    for k in ("psnr_gt", "psnr_hr", "psnr_full"):
        if k in hist:
            msg += f"  {k} {hist[k][-1]:.2f} dB"
    return msg


def _suffixed(out_path: str, name: str) -> str:
    stem, ext = os.path.splitext(out_path)
    return f"{stem}_{name}{ext or '.png'}"


def _save(path: str, out) -> None:
    from dip_tpu_torch.utils.image_io import nhwc_to_hwc, save_image

    save_image(path, np.clip(nhwc_to_hwc(out), 0, 1))
    print(f"saved {path}")


def cmd_fit(args):
    from dip_tpu_torch.tasks.base import run_task

    t0 = time.time()
    images = args.image.split(",") if args.image else [None]

    if len(images) > 1:
        # many independent fits on one device through FitQueue (each fit its
        # own CUDA graph on its own stream; their chunks overlap)
        from dip_tpu_torch.parallel import FitQueue

        q = FitQueue(callback=lambda name, it, hist: print(
            _hist_line(f"[{name}] ", it, hist), flush=True))
        total_iters = 0
        for i, image in enumerate(images):
            spec = _build_spec(args, image)
            name = os.path.splitext(os.path.basename(image))[0]
            q.add(spec, args.seed + i, name=name, device=args.device)
            total_iters += spec.cfg.num_iter
        results = q.run()
        dt = time.time() - t0
        print(f"done: {len(images)} fits, {total_iters} total iters in "
              f"{dt:.1f}s ({total_iters / dt:.1f} aggregate it/s)")
        if args.out:
            for name, (out, _, _) in results.items():
                _save(_suffixed(args.out, name), out)
        return

    spec = _build_spec(args, images[0])

    def cb(it, hist, state):
        print(_hist_line("", it, hist), flush=True)
        if args.save_ckpt:
            from dip_tpu_torch.fit.checkpoint import save_fit_state

            save_fit_state(args.save_ckpt, state)

    if args.profile:
        from dip_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            out, _, _ = run_task(spec, args.seed, device=args.device, callback=cb)
    else:
        out, _, _ = run_task(spec, args.seed, device=args.device, callback=cb)
    dt = time.time() - t0
    iters = spec.cfg.num_iter
    print(f"done: {iters} iters in {dt:.1f}s ({iters / dt:.1f} it/s)")
    if args.out:
        _save(args.out, out)


def cmd_bench(args):
    """The b1 row (f32, as the JAX CLI's bench), or with --batch > 1 the
    row of that many fits: BatchEngine over the mesh of every CUDA device
    where there are several (as the JAX bench shards them), else FitQueue."""
    import torch

    from dip_tpu_torch.bench import run_batch, run_bench, run_queue

    if args.batch > 1 and torch.cuda.device_count() > 1:
        run_batch(size=args.size, iters=args.iters, batch=args.batch, compute_dtype=None)
    elif args.batch > 1:
        run_queue(size=args.size, iters=args.iters, batch=args.batch, compute_dtype=None,
                  device=args.device)
    else:
        run_bench(size=args.size, iters=args.iters, device=args.device)


def cmd_eval_sr(args):
    if args.fleet:
        # each same-shape group as one BatchEngine program per device
        from dip_tpu_torch.eval.sr_eval import eval_sr_dataset_sharded
        from dip_tpu_torch.parallel.mesh import Mesh, make_mesh

        mesh = make_mesh() if args.device == "cuda" else Mesh([args.device])
        res = eval_sr_dataset_sharded(args.dir, mesh, factor=args.factor,
                                      num_iter=args.num_iter)
    else:
        from dip_tpu_torch.eval.sr_eval import eval_sr_dataset

        res = eval_sr_dataset(args.dir, factor=args.factor, num_iter=args.num_iter,
                              device=args.device)
    print(f"mean PSNR-Y: {res.mean_psnr_y:.3f} dB")
    print(res.latex_row())


def _add_device(parser):
    parser.add_argument("--device", default="cuda",
                        help="where the fits run: 'cuda' (default; fails without a CUDA "
                             "device), 'cuda:N' or 'cpu'")


def build_parser() -> tuple[argparse.ArgumentParser, argparse.ArgumentParser]:
    """(the parser, its `fit` subparser)."""
    p = argparse.ArgumentParser(prog="dip_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fit", help="run a DIP workload")
    f.add_argument("--config", default=None,
                   help="YAML file providing any of the flags below")
    f.add_argument("--task", default=None,
                   choices=["denoise", "inpaint", "restore", "sr",
                            "flash_no_flash", "feature_inversion",
                            "activation_max"])
    f.add_argument("--image", default=None,
                   help="input image path; a comma-separated list runs many "
                        "independent fits on one device (FitQueue), "
                        "outputs saved as OUT_<name>.png")
    f.add_argument("--mask", default="text",
                   help="inpaint: mask path | 'text' | 'bernoulli:FRAC'; "
                        "flash_no_flash: the no-flash image path")
    f.add_argument("--preset", default=None)
    f.add_argument("--sigma", type=float, default=25.0,
                   help="denoise: noise std in [0,255]; 0 = image already noisy")
    f.add_argument("--factor", type=int, default=4)
    f.add_argument("--resample-impl", default=None, choices=["xla", "pallas"],
                   help="the JAX package's SR downsampler switch; refused here")
    f.add_argument("--compute-dtype", default=None,
                   choices=["f32", "bfloat16"],
                   help="mixed-precision forward/backward (params and the loss "
                        "stay f32)")
    f.add_argument("--num-iter", type=int, default=None)
    f.add_argument("--log-every", type=int, default=None,
                   help="steps between host callbacks (the graphed chunk's length)")
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--out", default=None)
    f.add_argument("--backbone", default="alexnet_caffe",
                   help="FI/AM: frozen classifier "
                        "(alexnet_caffe|vgg19_caffe|vgg16_caffe|vgg19_pytorch_modified)")
    f.add_argument("--layer", default=None,
                   help="FI: comma list of tap layers (default fc6); "
                        "AM: the layer to maximize (default conv4)")
    f.add_argument("--weights", default=None,
                   help="FI/AM: a local torch .pth state dict to load (without it the "
                        "backbone has seeded random weights)")
    f.add_argument("--map-idx", default="2",
                   help="AM: unit index, or (fc layers) an ImageNet class "
                        "name resolved via the class map")
    f.add_argument("--window-size", type=int, default=20,
                   help="AM: spatial window for conv objectives")
    f.add_argument("--imsize", type=int, default=None,
                   help="FI/AM: classifier input size (default 227 alexnet / "
                        "224 vgg); the generator runs at the next /64 size")
    f.add_argument("--class-map", default=None,
                   help="path to an imagenet1000_clsid_to_human.txt-format "
                        "class map (default: $DIP_IMAGENET_CLASSMAP)")
    f.add_argument("--save-ckpt", default=None,
                   help="checkpoint the fit state at every log boundary")
    f.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace to this directory")
    _add_device(f)
    f.set_defaults(fn=cmd_fit)

    b = sub.add_parser("bench", help="iters/sec benchmark")
    b.add_argument("--size", type=int, default=512)
    b.add_argument("--iters", type=int, default=100)
    b.add_argument("--batch", type=int, default=1)
    _add_device(b)
    b.set_defaults(fn=cmd_bench)

    e = sub.add_parser("eval-sr", help="Set5/Set14 SR evaluation")
    e.add_argument("--dir", required=True)
    e.add_argument("--factor", type=int, default=4)
    e.add_argument("--num-iter", type=int, default=None)
    e.add_argument("--fleet", action="store_true",
                   help="shape-grouped fleet: each group as one BatchEngine program "
                        "per device of the mesh")
    _add_device(e)
    e.set_defaults(fn=cmd_eval_sr)
    return p, f


def main(argv=None) -> int:
    p, f = build_parser()
    args = p.parse_args(argv)
    if getattr(args, "config", None):
        from dip_tpu_torch.cli.config import apply_config, load_config

        defaults = {a.dest: a.default for a in f._actions}
        apply_config(args, load_config(args.config), defaults)
    for key, why in _NOT_PORTED.items():
        if getattr(args, key, None):
            p.error(why)
    if args.cmd == "fit" and not args.task:
        p.error("fit requires --task (via flags or --config)")
    if args.cmd == "fit" and not args.image and args.task != "activation_max":
        p.error("fit requires --image (activation_max is image-free)")
    args.fn(args)
    return 0


if __name__ == "__main__":
    main()
