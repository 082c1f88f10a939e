"""Train the port's AlexNet to nontrivial accuracy, export a torch
checkpoint, and run feature inversion and activation maximization on the
*trained* features, all offline.

 1. train dip_tpu_torch's AlexNet (pretrained/backbones.py, its
    parameters made trainable here only) on a 10-class procedural-image
    task (oriented gratings x colour palettes): Adam, softmax
    cross-entropy on fc8[:, :10] after caffe preprocessing; then the
    held-out accuracy;
 2. export the weights as a torch state dict in the caffe key layout of
    the reference's alexnet checkpoint ('conv1.weight' ... 'fc8.bias'),
    a genuine .pth file;
 3. reload it through pretrained/convert.py (the product path, into a
    frozen backbone) and invert a held-out image's fc6 with the standard
    recipe;
 4. maximize the trained class-3 logit at fc8 and close the loop: the
    classifier's argmax of the synthesized image, its margin, and the
    logit's gain against a gray input.

    python -m dip_tpu_torch.tools.train_backbone              # full
    python -m dip_tpu_torch.tools.train_backbone --quick      # 60 FI / AM iterations
    python -m dip_tpu_torch.tools.train_backbone --device cpu --steps 20 --quick
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from dip_tpu_torch.fit.engine import resolve_device
from dip_tpu_torch.pretrained.backbones import AlexNet, vgg_preprocess_caffe
from dip_tpu_torch.tasks.activation_maximization import task as am_task
from dip_tpu_torch.tasks.base import run_task
from dip_tpu_torch.tasks.feature_inversion import FeatureInversion, build_extractor
from dip_tpu_torch.tools import OUTDIR
from dip_tpu_torch.utils.image_io import load_image, nhwc_to_hwc, pil_to_np, save_image

CKPT_NAME = "alexnet_trained.pth"
N_CLASSES = 10
IMSIZE = 227


# --------------------------------------------------------------------------
# procedural dataset: class = (orientation bucket, palette) combination
# --------------------------------------------------------------------------

def make_batch(rng: np.random.Generator, n: int, imsize: int = IMSIZE):
    """Oriented sinusoidal gratings in one of 5 orientations x 2 palettes."""
    xs = np.empty((n, imsize, imsize, 3), np.float32)
    ys = rng.integers(0, N_CLASSES, size=n)
    yy, xx = np.mgrid[0:imsize, 0:imsize].astype(np.float32) / imsize
    for i, label in enumerate(ys):
        ori = (label % 5) * np.pi / 5 + rng.normal(0, 0.06)
        freq = rng.uniform(6, 14)
        phase = rng.uniform(0, 2 * np.pi)
        g = np.sin(2 * np.pi * freq * (np.cos(ori) * xx + np.sin(ori) * yy)
                   + phase) * 0.5 + 0.5
        if label < 5:
            img = np.stack([g, 1 - g, np.full_like(g, 0.5)], -1)
        else:
            img = np.stack([np.full_like(g, 0.5), g, 1 - g], -1)
        img += rng.normal(0, 0.05, img.shape)
        xs[i] = np.clip(img, 0, 1)
    return xs, ys.astype(np.int32)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def trainable_alexnet(seed: int, imsize: int = IMSIZE, *,
                      device: torch.device | str) -> AlexNet:
    """The port's AlexNet with its initial weights drawn from `seed`, every
    parameter trainable (the backbones are built frozen), on `device`."""
    model = AlexNet(imsize)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.requires_grad_(True)
    return model.to(resolve_device(device))


def loss_and_accuracy(model: AlexNet, x: torch.Tensor, y: torch.Tensor):
    """Softmax cross-entropy of fc8[:, :N_CLASSES] after caffe
    preprocessing, and the batch accuracy."""
    logits = model(vgg_preprocess_caffe(x), taps=("fc8",))["fc8"][:, :N_CLASSES]
    return F.cross_entropy(logits, y), (logits.argmax(-1) == y).float().mean()


def train(steps: int, batch: int, lr: float, seed: int = 0, *,
          device: torch.device | str):
    """`steps` Adam steps (torch.optim.Adam at optax.adam's defaults:
    betas 0.9 / 0.999, eps 1e-8 outside the square root) on fresh
    batches; returns (model, held-out accuracy on 64 images of seed + 1)."""
    dev = resolve_device(device)
    model = trainable_alexnet(seed, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rng = np.random.default_rng(seed)
    make_batch(rng, batch)  # the JAX tool inits from this batch: the same stream after it

    t0 = time.time()
    host = 0.0
    for i in range(steps):
        th = time.perf_counter()
        x, y = make_batch(rng, batch)
        host += time.perf_counter() - th
        loss, acc = loss_and_accuracy(model, torch.from_numpy(x).to(dev),
                                      torch.from_numpy(y).long().to(dev))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 20 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {loss.item():.4f}  acc {acc.item():.3f}", flush=True)
    wall = time.time() - t0
    print(f"trained {steps} steps in {wall:.1f}s; make_batch on the host {host:.1f}s "
          f"(host share {host / wall:.3f})", flush=True)

    xe, ye = make_batch(np.random.default_rng(seed + 1), 64)
    with torch.no_grad():
        logits = model(vgg_preprocess_caffe(torch.from_numpy(xe).to(dev)), taps=("fc8",))["fc8"]
    pred = logits[:, :N_CLASSES].argmax(-1).cpu().numpy()
    test_acc = float((pred == ye).mean())
    print(f"held-out accuracy: {test_acc:.3f}  ({time.time()-t0:.0f}s)", flush=True)
    return model, test_acc


# --------------------------------------------------------------------------
# export: the backbone's state dict, already the caffe key layout (.pth)
# --------------------------------------------------------------------------

def export_torch(model: AlexNet, path: str) -> None:
    """torch.save the weights as 'conv1.weight' ... 'fc8.bias' (OIHW convs,
    (out, in) fc weights), on the CPU."""
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save(state, path)
    print(f"exported {path} ({len(state)} tensors)", flush=True)


# --------------------------------------------------------------------------
# feature inversion from trained weights (the product path end-to-end)
# --------------------------------------------------------------------------

def run_inversion(weights_path: str, num_iter: int, layers=("fc6",),
                  content_path: str | None = None, *, device: torch.device | str,
                  outdir: str = OUTDIR):
    """Invert the content's `layers` through the checkpoint; returns the
    loss of the first and of the last step."""
    if content_path:
        content = pil_to_np(load_image(content_path).resize((IMSIZE, IMSIZE)))
    else:  # held-out procedural image
        content, _ = make_batch(np.random.default_rng(99), 1)
        content = content[0]

    fi = FeatureInversion(backbone="alexnet_caffe", layers=tuple(layers),
                          weights_path=weights_path, num_iter=num_iter, device=device)
    spec = fi.spec(content[None])

    out, state, hist = run_task(
        spec, 0, device=device,
        callback=lambda it, h, s: print(f"  iter {it:5d}  loss {h['loss'][-1]:.4f}",
                                        flush=True))
    os.makedirs(outdir, exist_ok=True)
    save_image(os.path.join(outdir, "fi_trained_content.png"), np.clip(content, 0, 1))
    save_image(os.path.join(outdir, "fi_trained_inversion.png"),
               np.clip(nhwc_to_hwc(out), 0, 1))
    return float(hist["loss"][0]), float(hist["loss"][-1])


# --------------------------------------------------------------------------
# activation maximization on the trained classifier (fc8 class logit)
# --------------------------------------------------------------------------

def run_am(weights_path: str, num_iter: int, map_idx: int = 3, *,
           device: torch.device | str, outdir: str = OUTDIR):
    """Maximize a *trained* class logit (the reference's AM recipe,
    activation_maximization.ipynb cells 11-22, on weights that mean
    something: class `map_idx` is an oriented-grating class, so the
    synthesized image should develop that orientation). Returns the first
    and last loss, the image's path and the closed loop: the classifier's
    argmax over the 10 trained classes, the margin over the runner-up, and
    the target logit's gain against a gray input."""
    spec = am_task(backbone="alexnet_caffe", layer="fc8", map_idx=map_idx,
                   weights_path=weights_path, num_iter=num_iter, device=device)
    out, state, hist = run_task(
        spec, 1, device=device,
        callback=lambda it, h, s: print(f"  am iter {it:5d}  loss {h['loss'][-1]:.4f}",
                                        flush=True))
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"am_trained_class{map_idx}.png")
    save_image(path, np.clip(nhwc_to_hwc(out), 0, 1))

    extract, _, _ = build_extractor("alexnet_caffe", ("fc8",), weights_path, device=device)
    with torch.no_grad():
        logits = extract(out)["fc8"][0, :N_CLASSES].cpu().numpy()
        logits0 = extract(torch.full_like(out, 0.5))["fc8"][0, :N_CLASSES].cpu().numpy()
    pred = int(logits.argmax())
    margin = float(logits[map_idx] - np.max(np.delete(logits, map_idx)))
    gain = float(logits[map_idx] - logits0[map_idx])
    print(f"  closed loop: argmax={pred} (target {map_idx}), "
          f"margin {margin:+.2f}, logit gain vs gray {gain:+.2f}", flush=True)
    closed = {"am_argmax": pred, "am_target": map_idx,
              "am_margin": round(margin, 3), "am_logit_gain": round(gain, 3)}
    return float(hist["loss"][0]), float(hist["loss"][-1]), path, closed


def _record(outdir: str, rec: dict) -> None:
    with open(os.path.join(outdir, "reproduce.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)


def main(argv=None, *, outdir: str = OUTDIR) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--fi-iters", type=int, default=3100)
    p.add_argument("--am-iters", type=int, default=3100)
    p.add_argument("--am-class", type=int, default=3)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--skip-train", action="store_true",
                   help=f"reuse an existing results_torch/{CKPT_NAME}")
    p.add_argument("--skip-fi", action="store_true",
                   help="skip the feature-inversion stage (AM only)")
    p.add_argument("--content", default=None,
                   help="image to invert (default: held-out procedural)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    if args.quick:
        args.fi_iters = min(args.fi_iters, 60)
        args.am_iters = min(args.am_iters, 60)

    os.makedirs(outdir, exist_ok=True)
    ckpt = os.path.join(outdir, CKPT_NAME)
    if args.skip_train and os.path.exists(ckpt):
        test_acc = -1.0
    else:
        model, test_acc = train(args.steps, args.batch, args.lr, device=args.device)
        export_torch(model, ckpt)
        del model
    if args.skip_fi:
        am0, am1, am_path, closed = run_am(ckpt, args.am_iters, args.am_class,
                                           device=args.device, outdir=outdir)
        _record(outdir, {"recipe": f"activation_max/trained-alexnet fc8[{args.am_class}]",
                         "image": "synthesized", "size": "227x227",
                         "iters": args.am_iters, "am_loss_first": round(am0, 4),
                         "am_loss_final": round(am1, 4), "out": am_path,
                         "quick": args.quick, **closed})
        return 0

    loss0, loss1 = run_inversion(ckpt, args.fi_iters, content_path=args.content,
                                 device=args.device, outdir=outdir)
    _record(outdir, {"recipe": "feature_inversion/trained-alexnet fc6",
                     "image": "held-out procedural", "size": f"{IMSIZE}x{IMSIZE}",
                     "backbone_test_acc": round(test_acc, 3),
                     "train_steps": args.steps,
                     "fi_iters": args.fi_iters,
                     "fi_loss_first": round(loss0, 4), "fi_loss_final": round(loss1, 4),
                     "out": os.path.join(outdir, "fi_trained_inversion.png"),
                     "ckpt": ckpt, "quick": args.quick})

    am0, am1, am_path, closed = run_am(ckpt, args.am_iters, args.am_class,
                                       device=args.device, outdir=outdir)
    _record(outdir, {"recipe": f"activation_max/trained-alexnet fc8[{args.am_class}]",
                     "image": "synthesized", "size": "227x227",
                     "backbone_test_acc": round(test_acc, 3),
                     "iters": args.am_iters,
                     "am_loss_first": round(am0, 4), "am_loss_final": round(am1, 4),
                     "out": am_path, "quick": args.quick, **closed})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
