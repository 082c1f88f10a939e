"""The correctness check end to end on the CPU, at the tiny size: a sound
run of each cell is correct, and a run with the timed path broken
underneath is not, once for each fault a cell can have; the control of a
bf16 configuration (the reference in fp8) fails that cell's limits."""

from __future__ import annotations

import json

import pytest
import torch

from dipbench import check, inputs
from dipbench.program import Program
from dipbench.tests.conftest import BENCH, REPO, run_cell, tiny_config

CPU = torch.device("cpu")

CELLS = ("f16_denoise.single", "kate_inpaint.single", "f16_denoise.batch8",
         "kate_inpaint.batch8")

# a step that leaves the state as it was: Adam computes the loss and its
# gradients and updates nothing
FROZEN = """
import torch
def _step(self, closure=None):
    with torch.enable_grad():
        return closure()
torch.optim.Adam.step = _step
"""

# half of the batch left out, the mean taken over the rest: the last half of
# the fits' losses drop out of the sum whose backward BatchEngine takes, the
# others count twice (the task's loss is the function vmapped by its name)
DROPPED = """
import dip_tpu_torch.parallel.batch as batch
_vmap = batch.vmap
def _fault_vmap(fn, *a, **k):
    v = _vmap(fn, *a, **k)
    if getattr(fn, "__name__", "") != "loss":
        return v
    def losses(*args):
        out = v(*args)
        half = out.shape[0] // 2
        keep = out.new_zeros(out.shape)
        keep[:out.shape[0] - half] = out.shape[0] / (out.shape[0] - half)
        return out * keep
    return losses
batch.vmap = _fault_vmap
"""


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(checkout, workload):
    r = run_cell(checkout, workload)
    assert r["rc"] == 0, r["stderr"]
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-3] == "checks"  # the last key of the result line (rc, stderr added here)


@pytest.mark.parametrize("workload", CELLS)
def test_frozen_step_is_not_correct(checkout, workload):
    r = run_cell(checkout, workload, setup=FROZEN)
    assert r["rc"] == 0, r["stderr"]
    assert r["correct"] is False
    assert r["checks"]["step_gap"]["value"] == pytest.approx(1.0)
    assert r["checks"]["step_med"]["value"] >= 0.99  # leaves below the median leaf read less


@pytest.mark.parametrize("workload", ("f16_denoise.batch8", "kate_inpaint.batch8"))
def test_dropped_half_batch_is_not_correct(checkout, workload):
    r = run_cell(checkout, workload, setup=DROPPED)
    assert r["rc"] == 0, r["stderr"]
    assert r["correct"] is False
    assert r["checks"]["grad_gap"]["value"] >= 0.99  # a fit left out reads 1
    assert r["checks"]["grad_med"]["value"] >= 0.9  # leaves below the median leaf read less


def test_fp8_control_is_three_times_the_program():
    """The reference in fp8 in the program's place, against the reference,
    at the test's size: its output gap is three times the bf16 program's or
    more, the separation a limit is set from (at the cell's own size the
    cells' limits refuse it: test_controls_fail_the_limits_on_the_card)."""
    cfg = tiny_config("skip_denoise_f16")
    tr = {"engine": "single", "fits": 1, "log_every": 4}
    made = inputs.make(cfg, 1, 5, CPU)
    prog = check.program_readings(Program(cfg, tr, made, CPU), made.weights)
    made = inputs.make(cfg, 1, 5, CPU)
    ref = check.reference_readings(cfg, made, CPU)
    ctl = check.reference_readings(cfg, made, CPU, **check.control(cfg))
    assert check.gaps(ctl, ref)[0]["out1_rms"] > 3 * check.gaps(prog, ref)[0]["out1_rms"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_controls_fail_the_limits_on_the_card(workload):
    """Each cell's control (the reference in fp8 below its bf16) at the
    cell's own size, on three seeds: the cell's limits refuse every one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    fits = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())["fits"]
    lims = check.limits(REPO, workload)
    dev = torch.device("cuda")
    for seed in (901, 902, 903):
        made = inputs.make(cfg, fits, seed, dev)
        ref = check.reference_readings(cfg, made, dev)
        values, _ = check.gaps(check.reference_readings(cfg, made, dev, **check.control(cfg)), ref)
        assert check.judge(dict(values, nonfinite=0), lims)[0] is False, values
