"""Set5/Set14 super-resolution evaluation (counterpart of
dip_tpu/eval/sr_eval.py): Y-channel PSNR inside a 4-px margin of the
non-zero bounding box of the DIP output, per image and averaged. Takes a
directory of HR images, runs the whole SR pipeline on each, and works
offline. `eval_sr_dataset` fits the images one after another;
`eval_sr_dataset_sharded` (the fleet) fits each group of same-shape images
through one BatchEngine over a device mesh, seeded image by image as the
sequential evaluation seeds them.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from dip_tpu_torch.ops.losses import psnr_y
from dip_tpu_torch.tasks import super_resolve
from dip_tpu_torch.tasks.base import make_input, run_task
from dip_tpu_torch.utils.image_io import hwc_to_nhwc, nhwc_to_hwc

SET14 = ["baboon", "barbara", "bridge", "coastguard", "comic", "face",
         "flowers", "foreman", "lenna", "man", "monarch", "pepper", "ppt3",
         "zebra"]
SET5 = ["baby", "bird", "butterfly", "head", "woman"]


def psnr_y_bbox_protocol(gt_hwc: np.ndarray, pred_hwc: np.ndarray,
                         ref_for_bbox: np.ndarray | None = None,
                         margin: int = 4) -> float:
    """Find the non-zero bounding box of the prediction (or of a reference
    output), shrink it by `margin` px, and take the PSNR of studio-swing Y."""
    ref = pred_hwc if ref_for_bbox is None else ref_for_bbox
    q = ref[..., :3].sum(-1)
    cols = np.where(q.sum(0) > 0)[0]
    rows = np.where(q.sum(1) > 0)[0]
    r0, r1 = rows[0] + margin, rows[-1] - margin
    c0, c1 = cols[0] + margin, cols[-1] - margin
    a = torch.as_tensor(np.asarray(gt_hwc[r0:r1, c0:c1, :3], dtype=np.float32))
    b = torch.as_tensor(np.asarray(pred_hwc[r0:r1, c0:c1, :3], dtype=np.float32))
    return float(psnr_y(a[None], b[None]))


@dataclass
class SrEvalResult:
    per_image: dict = field(default_factory=dict)
    mean_psnr_y: float = 0.0

    def latex_row(self, label: str = "dip-tpu") -> str:
        vals = " & ".join(f"${v:.4}$" for v in self.per_image.values())
        return f"\\small{{{label}}} & {vals}"


def eval_sr_dataset(
    image_dir: str,
    factor: int = 4,
    names: list[str] | None = None,
    num_iter: int | None = None,
    seed: int = 0,
    verbose: bool = True,
    *,
    device: torch.device | str,
) -> SrEvalResult:
    """Run DIP SR on every image in `image_dir` on `device` and score it
    with the paper's protocol. The images are HR ground truths; the LR
    observations come from the reference's PIL pipeline."""
    paths = sorted(glob.glob(os.path.join(image_dir, "*")))
    if names:
        paths = [p for p in paths if any(n in os.path.basename(p) for n in names)]
    result = SrEvalResult()
    scores = []
    for i, path in enumerate(paths):
        imgs = super_resolve.load_lr_hr(path, -1, factor, "CROP")
        spec = super_resolve.task(hwc_to_nhwc(imgs["LR_np"]), factor=factor,
                                  hr_gt=hwc_to_nhwc(imgs["HR_np"]), num_iter=num_iter)
        out, _, _ = run_task(spec, seed + i, device=device)
        pred = np.clip(nhwc_to_hwc(out), 0, 1)
        score = psnr_y_bbox_protocol(imgs["HR_np"], pred)
        name = os.path.splitext(os.path.basename(path))[0]
        result.per_image[name] = score
        scores.append(score)
        if verbose:
            print(f"{name}: {score:.3f} dB")
    result.mean_psnr_y = float(np.mean(scores)) if scores else 0.0
    return result


def eval_sr_dataset_sharded(
    image_dir: str,
    mesh,
    factor: int = 4,
    num_iter: int | None = None,
    seed: int = 0,
    verbose: bool = True,
) -> SrEvalResult:
    """Fleet evaluation over `mesh` (parallel.mesh.Mesh): the images are
    grouped by LR shape, and each group runs through one BatchEngine, as
    mesh-size sub-batches (one fit per device a pass). The last sub-batch
    is padded by repeating its last image, whose padding scores are
    dropped. Image i of the sorted list takes seed `seed + i` (its z from
    that seed, its weights and jitter from seed + i + 1 on), as
    eval_sr_dataset seeds it, so on a one-device mesh the fleet fits what
    the sequential evaluation fits. Scores come back in the sorted order."""
    from dip_tpu_torch.parallel.batch import BatchEngine

    paths = sorted(glob.glob(os.path.join(image_dir, "*")))
    groups: dict[tuple, list] = {}
    for i, path in enumerate(paths):
        imgs = super_resolve.load_lr_hr(path, -1, factor, "CROP")
        groups.setdefault(imgs["LR_np"].shape, []).append((i, path, imgs))

    scores: dict[int, tuple[str, float]] = {}
    for items in groups.values():
        n_real = len(items)
        while len(items) % mesh.size:
            items = items + [items[-1]]  # pad the last sub-batch
        spec = super_resolve.task(hwc_to_nhwc(items[0][2]["LR_np"]), factor=factor,
                                  num_iter=num_iter)
        beng = BatchEngine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn, mesh=mesh)
        outs = []
        for lo in range(0, len(items), mesh.size):  # one fit per device a pass
            sub = items[lo:lo + mesh.size]
            zs = torch.stack([make_input(spec, torch.Generator().manual_seed(seed + i), "cpu")
                              for i, _, _ in sub])
            auxs = {"lr": torch.stack([torch.as_tensor(hwc_to_nhwc(im["LR_np"]))
                                       for _, _, im in sub])}
            state = beng.init_state([seed + i + 1 for i, _, _ in sub], zs)
            state, _ = beng.run(state, auxs)
            outs.append(beng.render(state).cpu().numpy())  # (mesh size, 1, H, W, C)
        outs = np.concatenate(outs)
        for (i, path, imgs), out in zip(items[:n_real], outs):
            pred = np.clip(nhwc_to_hwc(out), 0, 1)
            scores[i] = (os.path.splitext(os.path.basename(path))[0],
                         psnr_y_bbox_protocol(imgs["HR_np"], pred))
    result = SrEvalResult()
    for i in sorted(scores):
        name, score = scores[i]
        result.per_image[name] = score
        if verbose:
            print(f"{name}: {score:.3f} dB")
    result.mean_psnr_y = float(np.mean(list(result.per_image.values()))) if scores else 0.0
    return result
