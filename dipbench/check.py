"""How `correct` is decided: the program's first three steps, taken through
the window's own call on the benchmark's inputs, against the plain
reference's from the same weights, inputs and jitter seeds.

The numbers compared (each fit of a batch on its own):
  loss1_gap  the first step's loss, |program - reference| / |reference|
  loss_gap   the same, worst of the three steps
  grad_gap   each leaf's norm of the first gradient as Adam got it, the gap
             of the two norms over the larger of the reference's norm of
             that leaf and of the median leaf, worst leaf: a leaf that the
             program leaves out, or counts twice, reads 1
  grad_med   the same gap of the median leaf, steady from seed to seed
  step_gap   each leaf's norm of its change over the three steps, measured
             the same way, worst leaf
  step_med   the same gap of the median leaf
  out1_rms   the root mean square of the gap of the first step's output
             (pixels in [0, 1]): a rounding that touches every pixel moves
             it, where a few stray roundings do not
  out_rms    the same of the output EMA after the three steps
  nonfinite  fit-iterations of the window whose loss was not finite
The leaf gaps leave out the leaves whose reference gradient is under a
thousandth of the median leaf's: a conv bias before a BatchNorm has a
gradient of nought to rounding, which the program's rounding (bf16 above
all) turns into noise that Adam then follows. Fits of a batch are judged
one by one: each number is the worst over the fits.
Each has its limit in limits/<workload>.json, null for a number that is
read but not compared; `correct` is every compared number at or under
its limit.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from dipbench import tasks
from dipbench.inputs import Inputs, fit_slice, jitter_seed, reference_net
from dipbench.reference import fit as ref_fit

STEPS = 3
CHECKS = ("loss1_gap", "loss_gap", "grad_gap", "grad_med", "step_gap", "step_med", "out1_rms",
          "out_rms", "nonfinite")
# a leaf whose reference gradient is under this share of the median leaf's
# has a gradient of nought to rounding: its gradient and change are not compared
MOVED = 1e-3


def program_readings(program, weights: dict[str, torch.Tensor]) -> dict:
    """The program's first STEPS steps through its window call: one step,
    then the rest."""
    rows = program.run(1)
    grad, out1 = program.grad_norms(), program.output()
    more = program.run(STEPS - 1)
    return {"losses": np.concatenate([rows["loss"], more["loss"]]), "grad": grad,
            "change": program.change_norms(weights), "out1": out1, "out": program.output()}


def control(cfg: dict) -> dict:
    """reference_readings' arguments for the configuration's control: the
    reference put in the program's place in the precision below the one
    the configuration states, fp8 operands below bf16."""
    if cfg["precision"] != "bfloat16":
        raise NotImplementedError(f"no control for precision {cfg['precision']!r}")
    return {"operands": "fp8"}


def reference_readings(cfg: dict, inputs: Inputs, device: torch.device,
                       operands: str | None = None, frozen: bool = False,
                       dropped: int = 0) -> dict:
    """The reference's readings, fit by fit, on the same inputs. `operands`
    rounds its conv operands ('fp8': the control); `frozen` plants a step
    that leaves the state unchanged, `dropped` leaves that many of the last
    fits out of the loss (their gradients nought, their weights unmoved)."""
    net, loss = reference_net(cfg), tasks.load(cfg["task"]).reference_loss
    fits = inputs.z.shape[0]
    losses, grad, change, out1, outs = [], {}, {}, [], []
    for i in range(fits):
        w0 = {k: v[i] for k, v in inputs.weights.items()}
        gen = torch.Generator(device=device).manual_seed(jitter_seed(inputs.fit_seeds[i]))
        left_out = i >= fits - dropped
        r = ref_fit.first_steps(lambda p, z: net.forward(p, cfg["net"], z, operands), loss,
                                w0, inputs.z[i], fit_slice(inputs.aux, i), cfg["fit"], gen,
                                STEPS, update=not (frozen or left_out))
        losses.append(r["losses"])
        for k in w0:
            g = torch.zeros_like(r["grad1"][k]) if left_out else r["grad1"][k]
            grad.setdefault(k, []).append(_norm(g))
            change.setdefault(k, []).append(_norm(r["params"][k] - w0[k]))
        out1.append(r["out1"].cpu())
        outs.append(r["out"].cpu())
    return {"losses": np.array(losses).T, "grad": {k: np.array(v) for k, v in grad.items()},
            "change": {k: np.array(v) for k, v in change.items()}, "out1": torch.stack(out1),
            "out": torch.stack(outs)}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(torch.float64)))


def _leaf_gaps(prog: dict, ref: dict, keep) -> tuple[float, str, float]:
    """Each kept leaf's |prog - ref| / max(ref, median ref): the worst over
    fits and leaves and where ('leaf' or 'leaf[fit]'), and the worst over
    fits of the median leaf's."""
    worst, where, median = 0.0, "", 0.0
    keys = list(ref)
    fits = len(ref[keys[0]])
    for i in range(fits):
        names = [k for k in keys if keep(k, i)]
        floor = max(float(np.median([ref[k][i] for k in names])), 1e-30)
        fit_gaps = []
        for k in names:
            gap = abs(prog[k][i] - ref[k][i]) / max(ref[k][i], floor)
            fit_gaps.append(gap)
            if not gap <= worst:  # NaN too
                worst, where = float(gap), k + (f"[{i}]" if fits > 1 else "")
        mid = float(np.median(fit_gaps))
        if not mid <= median:
            median = mid
    return worst, where, median


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).square().mean().sqrt())


def gaps(prog: dict, ref: dict) -> tuple[dict[str, float], dict[str, str]]:
    """The numbers compared (but nonfinite), program readings against the
    reference's, and the leaf each leaf gap is worst at."""
    med = {i: float(np.median([ref["grad"][k][i] for k in ref["grad"]]))
           for i in range(len(next(iter(ref["grad"].values()))))}
    moved = lambda k, i: ref["grad"][k][i] >= MOVED * med[i]  # noqa: E731
    lp, lr = np.asarray(prog["losses"], np.float64), np.asarray(ref["losses"], np.float64)
    rel = np.abs(lp - lr) / np.abs(lr)
    grad, grad_at, grad_med = _leaf_gaps(prog["grad"], ref["grad"], moved)
    step, step_at, step_med = _leaf_gaps(prog["change"], ref["change"], moved)
    values = {"loss1_gap": float(np.max(rel[0])), "loss_gap": float(np.max(rel)),
              "grad_gap": grad, "grad_med": grad_med, "step_gap": step, "step_med": step_med,
              "out1_rms": _rms(prog["out1"], ref["out1"]),
              "out_rms": _rms(prog["out"], ref["out"])}
    return values, {"grad_gap": grad_at, "step_gap": step_at}


def limits(checkout: Path, workload: str) -> dict[str, float | None]:
    """Each number's limit, from limits/<workload>.json (None: not compared)."""
    data = json.loads((checkout / "dipbench" / "limits" / f"{workload}.json").read_text())
    return {k: data[k]["limit"] for k in CHECKS}


def judge(values: dict[str, float], lims: dict[str, float | None]) -> tuple[bool, dict]:
    """(every compared number at or under its limit, {name: {value, limit}});
    a number that is not finite fails."""
    table = {k: {"value": values[k], "limit": lims[k]} for k in CHECKS}
    return all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values()
               if v["limit"] is not None), table
