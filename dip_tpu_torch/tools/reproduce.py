"""Reproduce the reference's flagship recipes on its own bundled images.

Runs every headline workload from the reference notebooks on the files of
the reference's data/ directory, named by $DIP_REFERENCE_DATA
(denoising.ipynb cell 6, inpainting.ipynb cell 7, super-resolution.ipynb
cell 5, restoration.ipynb cell 7, flash-no-flash.ipynb) with the exact
notebook hyperparameters, records quality and throughput per recipe, and
writes the output images to results_torch/.

    python -m dip_tpu_torch.tools.reproduce                   # all recipes, full iters
    python -m dip_tpu_torch.tools.reproduce --only f16,kate   # subset
    python -m dip_tpu_torch.tools.reproduce --quick           # 20-iter smoke of each
    python -m dip_tpu_torch.tools.reproduce --quick-gate      # the bf16 quality gate

Each run appends one JSON line to results_torch/reproduce.jsonl (the gate:
results_torch/gate.jsonl). A recipe that raises is reported with its
traceback, the others run, and the run exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from dip_tpu_torch.data import reference_data_dir
from dip_tpu_torch.eval.sr_eval import psnr_y_bbox_protocol
from dip_tpu_torch.tasks import denoise, flash_no_flash, inpaint, restore, super_resolve
from dip_tpu_torch.tasks.base import run_task
from dip_tpu_torch.tools import OUTDIR
from dip_tpu_torch.utils.image_io import (crop_image, hwc_to_nhwc, load_image, nhwc_to_hwc,
                                          pil_to_np, save_image)
from dip_tpu_torch.utils.masks import get_bernoulli_mask


@dataclasses.dataclass
class Runner:
    """Where a sweep reads and writes, and how it fits: the reference's
    data/ directory, the output directory, the record log, the device and
    the compute dtype (None: the recipe's own, f32)."""

    data: str
    outdir: str
    log: str
    device: str = "cuda"
    compute_dtype: str | None = None

    def load(self, name: str, d: int = 32) -> np.ndarray:
        return pil_to_np(crop_image(load_image(self.path(name)), d=d))

    def path(self, name: str) -> str:
        return os.path.join(self.data, name)

    def save(self, name: str, arr_nhwc) -> str:
        os.makedirs(self.outdir, exist_ok=True)
        if self.compute_dtype:  # don't clobber the f32 reference outputs
            name = f"{self.compute_dtype}_{name}"
        path = os.path.join(self.outdir, name)
        save_image(path, np.clip(nhwc_to_hwc(arr_nhwc), 0, 1))
        return path

    def run(self, spec, seed: int = 0):
        """(output, state, history, seconds) of the fit of `spec`."""
        if self.compute_dtype:  # 'float32' is the engine's own dtype: None
            spec.cfg = dataclasses.replace(spec.cfg, compute_dtype=None if (
                self.compute_dtype == "float32") else self.compute_dtype)

        def cb(it, hist, state):
            msg = f"  iter {it:5d}  loss {hist['loss'][-1]:.6f}"
            for k in ("psnr_gt", "psnr_gt_sm", "psnr_hr", "psnr_full"):
                if k in hist:
                    msg += f"  {k} {hist[k][-1]:.2f}"
            print(msg, flush=True)

        t0 = time.time()
        out, state, hist = run_task(spec, seed, device=self.device, callback=cb)
        return out, state, hist, time.time() - t0


def _stats(hist, key):
    if key not in hist:
        return {}
    h = np.asarray(hist[key])
    return {f"{key}_final": round(float(h[-1]), 3),
            f"{key}_best": round(float(h.max()), 3)}


# --------------------------------------------------------------------------
# recipes
# --------------------------------------------------------------------------

def recipe_f16(r: Runner, iters=None):
    """denoising.ipynb: F16, sigma=25, 3000 Adam iters (cells 6-10)."""
    img = r.load("denoising/F16_GT.png")
    noisy = denoise.get_noisy_image(img, 25 / 255.0)
    spec = denoise.task(hwc_to_nhwc(noisy), preset="f16",
                        gt=hwc_to_nhwc(img), num_iter=iters)
    out, state, hist, dt = r.run(spec)
    rec = {"recipe": "denoise/f16 sigma=25", "image": "F16_GT.png",
           "size": f"{img.shape[1]}x{img.shape[0]}",
           "psnr_noisy_input": round(float(
               -10 * np.log10(np.mean((noisy - img) ** 2))), 3)}
    rec.update(_stats(hist, "psnr_gt"))
    rec.update(_stats(hist, "psnr_gt_sm"))
    rec["out"] = r.save("f16_out.png", out)
    r.save("f16_ema.png", state.ema_out)
    return rec, hist, dt, spec.cfg.num_iter


def recipe_snail(r: Runner, iters=None):
    """denoising.ipynb blind de-JPEG: snail, 2400 iters, no GT."""
    img = r.load("denoising/snail.jpg")
    spec = denoise.task(hwc_to_nhwc(img), preset="snail", num_iter=iters)
    out, state, hist, dt = r.run(spec)
    rec = {"recipe": "denoise/snail (blind de-JPEG)", "image": "snail.jpg",
           "size": f"{img.shape[1]}x{img.shape[0]}",
           "loss_final": round(float(np.asarray(hist["loss"])[-1]), 6)}
    rec["out"] = r.save("snail_out.png", state.ema_out)
    return rec, hist, dt, spec.cfg.num_iter


def _inpaint(r: Runner, name, preset, iters, net_type=None):
    img = r.load(f"inpainting/{name}.png", d=64)
    mask = r.load(f"inpainting/{name}_mask.png", d=64)
    spec = inpaint.task(hwc_to_nhwc(img), hwc_to_nhwc(mask), preset=preset,
                        net_type=net_type or "skip", gt=hwc_to_nhwc(img), num_iter=iters)
    out, state, hist, dt = r.run(spec)
    rec = {"recipe": f"inpaint/{preset}" + (f" [{net_type}]" if net_type else ""),
           "image": f"{name}.png", "size": f"{img.shape[1]}x{img.shape[0]}"}
    rec.update(_stats(hist, "psnr_gt"))
    out_name = f"{name}_inpaint_{net_type.lower()}.png" if net_type else f"{name}_inpaint.png"
    rec["out"] = r.save(out_name, out)
    return rec, hist, dt, spec.cfg.num_iter


def recipe_kate(r: Runner, iters=None):
    """inpainting.ipynb cell 14 'kate': text mask, 6001 iters — the README
    convergence smoke test."""
    return _inpaint(r, "kate", "kate", iters)


def recipe_vase(r: Runner, iters=None):
    """inpainting.ipynb 'vase': meshgrid input, 5001 iters."""
    return _inpaint(r, "vase", "vase", iters)


def recipe_library(r: Runner, iters=None):
    """inpainting.ipynb 'library': deep 6-scale net + weight jitter, 3001."""
    return _inpaint(r, "library", "library", iters)


def recipe_library_unet(r: Runner, iters=None):
    """inpainting.ipynb cell 14 'library' UNET variant (LR 1e-3)."""
    return _inpaint(r, "library", "library", iters, net_type="UNet")


def recipe_library_resnet(r: Runner, iters=None):
    """inpainting.ipynb cell 14 'library' ResNet variant (LR 1e-3)."""
    return _inpaint(r, "library", "library", iters, net_type="ResNet")


def recipe_prior_effect(r: Runner, iters=None):
    """sr_prior_effect.ipynb cells 8-10: x4 SR with the skip prior vs NO
    network (identity, OPT_OVER='input' — optimize HR pixels directly).
    The PSNR gap between the two rows is the deep image prior itself."""
    imgs = super_resolve.load_lr_hr(r.path("sr/zebra_GT.png"), -1, 4, "CROP")
    lr = hwc_to_nhwc(imgs["LR_np"])
    gt = hwc_to_nhwc(imgs["HR_np"])
    scores, dts, n_iters, path = {}, 0.0, 0, None
    for net in ("skip", "identity"):
        spec = super_resolve.task(lr, factor=4, hr_gt=gt, num_iter=iters, net=net)
        out, state, hist, dt = r.run(spec, seed=0)
        pred = np.clip(nhwc_to_hwc(out), 0, 1)
        scores[net] = round(psnr_y_bbox_protocol(imgs["HR_np"], pred), 3)
        path = r.save(f"prior_effect_{net}.png", out)
        dts += dt
        n_iters += spec.cfg.num_iter
    rec = {"recipe": "sr_prior_effect/x4 zebra (skip vs identity)",
           "image": "zebra_GT.png",
           "size": f"{imgs['HR_np'].shape[1]}x{imgs['HR_np'].shape[0]}",
           "psnr_y_skip": scores["skip"], "psnr_y_identity": scores["identity"],
           "prior_effect_db": round(scores["skip"] - scores["identity"], 3),
           "out": path}
    return rec, {}, dts, n_iters


def recipe_lbfgs_f16(r: Runner, iters=None):
    """optimize('LBFGS') on a real image (utils/common_utils.py:208-221
    semantics: 100-step Adam warm-up then full-history LBFGS): F16 sigma=25
    denoising with the lbfgs engine mode."""
    img = r.load("denoising/F16_GT.png")
    noisy = denoise.get_noisy_image(img, 25 / 255.0)
    spec = denoise.task(hwc_to_nhwc(noisy), preset="f16",
                        gt=hwc_to_nhwc(img), num_iter=iters or 600)
    spec.cfg = dataclasses.replace(spec.cfg, optimizer="lbfgs",
                                   lbfgs_warmup=100, lbfgs_warmup_lr=1e-3,
                                   reg_noise_std=0.0)
    out, state, hist, dt = r.run(spec)
    rec = {"recipe": "denoise/f16 sigma=25 [LBFGS]", "image": "F16_GT.png",
           "size": f"{img.shape[1]}x{img.shape[0]}",
           "warmup": 100}
    rec.update(_stats(hist, "psnr_gt"))
    rec["out"] = r.save("f16_lbfgs_out.png", out)
    return rec, hist, dt, spec.cfg.num_iter


def recipe_barbara(r: Runner, iters=None):
    """restoration.ipynb cell 7: barbara, 50% pixels dropped, 11000 iters."""
    img = r.load("restoration/barbara.png", d=64)
    mask = get_bernoulli_mask(img.shape, zero_fraction=0.5)
    spec = restore.task(hwc_to_nhwc(img * mask), hwc_to_nhwc(mask),
                        preset="barbara", num_iter=iters,
                        gt=hwc_to_nhwc(img))
    out, state, hist, dt = r.run(spec)
    rec = {"recipe": "restore/barbara 50%", "image": "barbara.png",
           "size": f"{img.shape[1]}x{img.shape[0]}"}
    rec.update(_stats(hist, "psnr_full"))
    rec["out"] = r.save("barbara_restore.png", out)
    return rec, hist, dt, spec.cfg.num_iter


def _zebra(r: Runner, factor, iters):
    imgs = super_resolve.load_lr_hr(r.path("sr/zebra_GT.png"), -1, factor, "CROP")
    bicubic, sharp, nearest = super_resolve.get_baselines(
        imgs["LR_pil"], imgs["HR_pil"])
    spec = super_resolve.task(hwc_to_nhwc(imgs["LR_np"]), factor=factor,
                              hr_gt=hwc_to_nhwc(imgs["HR_np"]),
                              num_iter=iters)
    out, state, hist, dt = r.run(spec)
    pred = np.clip(nhwc_to_hwc(out), 0, 1)
    hr = imgs["HR_np"]
    rec = {"recipe": f"sr/x{factor} zebra", "image": "zebra_GT.png",
           "size": f"{hr.shape[1]}x{hr.shape[0]}",
           "psnr_y_protocol": round(psnr_y_bbox_protocol(hr, pred), 3),
           "psnr_y_bicubic": round(psnr_y_bbox_protocol(hr, bicubic), 3),
           "psnr_y_nearest": round(psnr_y_bbox_protocol(hr, nearest), 3)}
    rec.update(_stats(hist, "psnr_hr"))
    rec["out"] = r.save(f"zebra_x{factor}.png", out)
    return rec, hist, dt, spec.cfg.num_iter


def recipe_zebra4(r: Runner, iters=None):
    """super-resolution.ipynb: zebra x4, 2000 iters, PSNR-Y bbox protocol."""
    return _zebra(r, 4, iters)


def recipe_zebra8(r: Runner, iters=None):
    """super-resolution.ipynb: zebra x8, 4000 iters."""
    return _zebra(r, 8, iters)


def recipe_flash(r: Runner, iters=None):
    """flash-no-flash.ipynb: cave pair, 601 iters, LR 0.1."""
    flash = r.load("flash_no_flash/cave01_00_flash.jpg")
    noflash = r.load("flash_no_flash/cave01_01_noflash.jpg")
    spec = flash_no_flash.task(hwc_to_nhwc(flash), hwc_to_nhwc(noflash),
                               num_iter=iters or 601)
    out, state, hist, dt = r.run(spec)
    rec = {"recipe": "flash_no_flash/cave", "image": "cave01 pair",
           "size": f"{flash.shape[1]}x{flash.shape[0]}",
           "loss_final": round(float(np.asarray(hist["loss"])[-1]), 6)}
    rec["out"] = r.save("cave_out.png", out)
    return rec, hist, dt, spec.cfg.num_iter


RECIPES = {
    "f16": recipe_f16,
    "snail": recipe_snail,
    "kate": recipe_kate,
    "vase": recipe_vase,
    "library": recipe_library,
    "library_unet": recipe_library_unet,
    "library_resnet": recipe_library_resnet,
    "barbara": recipe_barbara,
    "zebra4": recipe_zebra4,
    "zebra8": recipe_zebra8,
    "flash": recipe_flash,
    "prior_effect": recipe_prior_effect,
    "lbfgs_f16": recipe_lbfgs_f16,
}


# The quality gate: three recipes at reduced iterations must clear
# conservative PSNR floors. The floors are far below the full-run numbers
# on the reference's photos (f16 ~30.7, kate ~37+, zebra4 psnr_hr ~26) but
# far above what a broken numeric path produces (single digits / low
# teens): a pass means the path still converges; it does not replace the
# full sweep.
QUICK_GATE = {  # name -> (reduced_iters, history_key, psnr_floor_dB)
    "f16": (1000, "psnr_gt", 27.0),
    "kate": (1500, "psnr_gt", 27.0),
    "zebra4": (1000, "psnr_hr", 21.0),
}

# bf16 quality budget: bf16 is the headline dtype, so its cost against f32
# is a tracked budget. At gate iterations, each recipe's bf16 best PSNR
# must be >= the f32 best - GATE_DELTA_DB. The f32 rows come from the
# newest matching f32 rows of gate.jsonl (refresh with
# `--quick-gate --compute-dtype float32`); the delta is recorded on every
# bf16 gate row as `delta_vs_f32_db`.
GATE_DELTA_DB = 0.75

# gate name -> the "recipe" label its record carries (sans dtype tag)
GATE_LABELS = {
    "f16": "denoise/f16 sigma=25",
    "kate": "inpaint/kate",
    "zebra4": "sr/x4 zebra",
}


def _latest_f32_gate_rows(log_path, names):
    """newest f32 gate row per recipe base name at the gate iters."""
    ref = {}
    if not os.path.exists(log_path):
        return ref
    base = {GATE_LABELS.get(n, n): n for n in names}
    with open(log_path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("compute_dtype") != "float32":
                continue
            label = r.get("recipe", "").replace(" [float32]", "")
            name = base.get(label)
            if name is not None and r.get("iters") == QUICK_GATE[name][0]:
                ref[name] = r  # later lines win: newest
    return ref


def gate_verdict(best, floor: float, delta, compute_dtype: str | None) -> tuple[bool, bool]:
    """(below the floor, over the bf16 budget) of one gate row; the budget
    binds only a bf16 row with an f32 row to compare with."""
    fail_floor = best is None or float(best) < floor
    fail_delta = (compute_dtype == "bfloat16" and delta is not None
                  and delta < -GATE_DELTA_DB)
    return fail_floor, fail_delta


def run_recipe(r: Runner, name: str, iters: int | None, *, quick: bool = False,
               f32_ref: dict | None = None) -> dict:
    """Run recipe `name` (`iters` steps, None: the notebook's), append its
    record to r.log and return it. With `f32_ref` (a gate run: the f32
    gate rows by name), the record carries the gate's f32 best and the
    delta from it."""
    rec, hist, dt, iters = RECIPES[name](r, iters)
    rec.update({"iters": int(iters), "seconds": round(dt, 1),
                "it_per_s": round(iters / dt, 2), "quick": bool(quick),
                "device": torch.cuda.get_device_name(torch.device(r.device))
                if torch.device(r.device).type == "cuda" else "cpu"})
    if r.compute_dtype:
        rec["compute_dtype"] = r.compute_dtype
        rec["recipe"] += f" [{r.compute_dtype}]"
    if f32_ref is not None:
        key = QUICK_GATE[name][1]
        best = rec.get(f"{key}_best")
        ref_best = f32_ref.get(name, {}).get(f"{key}_best")
        if best is not None and ref_best is not None:
            rec["f32_ref_best"] = ref_best
            rec["delta_vs_f32_db"] = round(float(best) - float(ref_best), 3)
    os.makedirs(os.path.dirname(r.log) or ".", exist_ok=True)
    with open(r.log, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None, *, outdir: str = OUTDIR) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", default=None,
                   help="comma-separated subset of " + ",".join(RECIPES))
    p.add_argument("--quick", action="store_true",
                   help="20-iter smoke run of every recipe")
    p.add_argument("--quick-gate", action="store_true",
                   help="bf16 quality gate (f16+kate+zebra4, reduced iters, "
                        "PSNR floors, the bf16-vs-f32 budget)")
    p.add_argument("--compute-dtype", default=None,
                   help="e.g. bfloat16: run recipes in mixed precision "
                        "(records tagged with the dtype)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    compute_dtype = args.compute_dtype
    if args.quick_gate:
        if args.only or args.quick:
            p.error("--quick-gate is its own mode (no --only/--quick)")
        compute_dtype = args.compute_dtype or "bfloat16"
    if args.quick_gate:
        names = list(QUICK_GATE)
    else:
        names = list(RECIPES) if not args.only else args.only.split(",")
    unknown = [n for n in names if n not in RECIPES]
    if unknown:
        p.error(f"unknown recipes {unknown}; choose from {','.join(RECIPES)}")

    data = reference_data_dir()  # raises with what to do if absent
    log = os.path.join(outdir, "gate.jsonl" if args.quick_gate else "reproduce.jsonl")
    r = Runner(data, outdir, log, args.device, compute_dtype)
    f32_ref = None
    if args.quick_gate:
        f32_ref = _latest_f32_gate_rows(log, names) if compute_dtype == "bfloat16" else {}
        missing = [n for n in names if n not in f32_ref]
        if compute_dtype == "bfloat16" and missing:
            print(f"note: no f32 gate rows at gate iters for {missing} — "
                  "delta budget unchecked there; refresh with "
                  "`--quick-gate --compute-dtype float32`", flush=True)
    failures, records = [], {}
    for name in names:
        print(f"=== {name} ===", flush=True)
        if args.quick_gate:
            run_iters = QUICK_GATE[name][0]
        elif args.quick:
            run_iters = 20
        else:
            run_iters = None
        try:
            records[name] = run_recipe(r, name, run_iters, quick=args.quick, f32_ref=f32_ref)
        except Exception:  # a failed recipe is reported and the sweep goes on
            traceback.print_exc()
            failures.append(name)
    if failures:
        print(f"FAILED recipes: {failures}", flush=True)
        return 1
    if args.quick_gate:
        bad = []
        for name, rec in records.items():
            _, key, floor = QUICK_GATE[name]
            best, delta = rec.get(f"{key}_best"), rec.get("delta_vs_f32_db")
            fail_floor, fail_delta = gate_verdict(best, floor, delta, compute_dtype)
            dtxt = ("delta=n/a" if delta is None
                    else f"delta={delta:+.2f}dB(budget -{GATE_DELTA_DB})")
            status = "FAIL" if (fail_floor or fail_delta) else "PASS"
            print(f"gate {name:8s} {key}_best={best} floor={floor} {dtxt} {status}",
                  flush=True)
            if fail_floor or fail_delta:
                bad.append(name)
        if bad:
            print("QUICK-GATE FAILED", flush=True)
            return 3
        print("QUICK-GATE PASSED", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
