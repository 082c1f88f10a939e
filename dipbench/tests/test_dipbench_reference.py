"""The plain reference against the port's plain CPU path at a small size:
the same parameters in the same order, the same forward, and the same
first steps of a fit; and the reference's rounded operands."""

from __future__ import annotations

import json

import pytest
import torch
from dip_tpu_torch.models import Skip

from dipbench import check, inputs
from dipbench.program import Program
from dipbench.reference import skip as ref_skip
from dipbench.tests.conftest import BENCH, tiny_config

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ("skip_denoise_f16", "skip_inpaint_kate"))
def test_parameters_match_the_port(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    mine = {p.name: p.shape for p in ref_skip.param_list(cfg["net"], 512, 512)}
    port = {k: tuple(v.shape) for k, v in Skip(**cfg["net"]).named_parameters()}
    assert mine == port


@pytest.mark.parametrize("name", ("skip_denoise_f16", "skip_inpaint_kate"))
def test_forward_matches_the_port(name):
    cfg = tiny_config(name)
    made = inputs.make(cfg, 1, 11, CPU)
    w = {k: v[0] for k, v in made.weights.items()}
    model = Skip(**cfg["net"], up_conv=False)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(w[k])
        want = model(made.z[0])
    got = ref_skip.forward(w, cfg["net"], made.z[0])
    assert (got - want).abs().max() < 1e-5


@pytest.mark.parametrize("operands", ("bf16", "fp8"))
def test_rounded_operands(operands):
    """A conv with rounded operands equals the f32 conv of the rounded
    operands, forward and backward, and its rounding is what its name says:
    bf16 moves an output by about 2^-9 of its size, fp8 by more."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 9, 7, generator=g, requires_grad=True)
    w = torch.randn(5, 8, 3, 3, generator=g, requires_grad=True)
    fwd, bwd = ref_skip.ROUNDINGS[operands]
    got = ref_skip._conv(x, w, 1, operands)
    ct = torch.randn(got.shape, generator=g)
    gx, gw = torch.autograd.grad(got, (x, w), ct)
    xq, wq = fwd(x.detach()).requires_grad_(), fwd(w.detach()).requires_grad_()
    want = torch.nn.functional.conv2d(xq, wq)
    wx, ww = torch.autograd.grad(want, (xq, wq), bwd(ct))
    for a, b in ((got, want), (gx, wx), (gw, ww)):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)
    exact = torch.nn.functional.conv2d(x.detach(), w.detach())
    rel = float((got.detach() - exact).norm() / exact.norm())
    assert (2e-4 < rel < 1e-2) if operands == "bf16" else (1e-2 < rel < 0.2)


@pytest.mark.parametrize("traffic", ("single", "batch8"))
def test_first_steps_match_the_port(traffic):
    """An f32 fit without the seam on the CPU: the port's first three steps
    and the reference's agree to f32 rounding."""
    cfg = tiny_config("skip_denoise_f16")
    cfg["precision"] = "float32"
    cfg["net"]["up_conv"] = False
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    tr.update(fits=min(tr["fits"], 2), log_every=4)
    made = inputs.make(cfg, tr["fits"], 11, CPU)
    prog = check.program_readings(Program(cfg, tr, made, CPU), made.weights)
    ref = check.reference_readings(cfg, inputs.make(cfg, tr["fits"], 11, CPU), CPU)
    values, _ = check.gaps(prog, ref)
    assert values["loss_gap"] < 1e-5 and values["out_rms"] < 1e-5
    assert values["grad_gap"] < 1e-4 and values["step_gap"] < 1e-3
    assert values["grad_med"] <= values["grad_gap"] and values["step_med"] <= values["step_gap"]
