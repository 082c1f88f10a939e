"""The benchmark's FLOP counter against a closed form for a 2-scale skip
net and against torch's own counter over the reference's step, and the
seam's least time against chip_smoke.seam_bound's arithmetic."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dipbench import flops
from dipbench.reference import skip as ref_skip
from dipbench.tasks.denoise import reference_loss
from dipbench.tests.conftest import BENCH, tiny_config

NET2 = {"num_input_channels": 2, "num_output_channels": 3, "num_channels_down": [4, 6],
        "num_channels_up": [5, 7], "num_channels_skip": [1, 2], "filter_size_down": 3,
        "filter_size_up": 3, "filter_skip_size": 1, "need_sigmoid": True, "need_bias": True,
        "pad": "reflection", "upsample_mode": "bilinear", "downsample_mode": "stride",
        "act_fun": "LeakyReLU", "need1x1_up": True}


def _cfg(net, h, w, precision) -> dict:
    return {"reference": "skip", "net": net, "precision": precision,
            "image": {"height": h, "width": w}}


def test_two_scale_closed_form():
    # multiply-adds of each conv at 8x8: the first two read z (no input gradient)
    reads_z = 8 * 8 * 1 * 2 + 4 * 4 * 4 * 2 * 9
    rest = (4 * 4 * 4 * 4 * 9 + 4 * 4 * 2 * 4 + 2 * 2 * 6 * 4 * 9 + 2 * 2 * 6 * 6 * 9
            + 4 * 4 * 7 * 8 * 9 + 4 * 4 * 7 * 7 + 8 * 8 * 5 * 8 * 9 + 8 * 8 * 5 * 5
            + 8 * 8 * 3 * 5)
    assert flops.fit_iteration_flops(_cfg(NET2, 8, 8, "bfloat16")) == 2.0 * (2 * reads_z + 3 * rest)
    assert flops.least_fit_iteration_s(_cfg(NET2, 8, 8, "float32")) \
        == 2.0 * (2 * reads_z + 3 * rest) / 67e12
    assert flops.seam_levels(_cfg(NET2, 8, 8, {})) == [(2, 2, 6, 7), (4, 4, 7, 5)]


@pytest.mark.parametrize("name", ("skip_denoise_f16", "skip_inpaint_kate"))
def test_against_torch_flop_counter(name):
    cfg = tiny_config(name)
    h, w = cfg["image"]["height"], cfg["image"]["width"]
    params = {p.name: (torch.rand(p.shape) * 0.2 - 0.1).requires_grad_()
              for p in ref_skip.param_list(cfg["net"], h, w)}
    z = torch.rand(1, h, w, cfg["net"]["num_input_channels"])
    with FlopCounterMode(display=False) as counter:
        out = ref_skip.forward(params, cfg["net"], z)
        torch.autograd.grad(reference_loss(out, torch.rand_like(out)), list(params.values()))
    assert counter.get_total_flops() == flops.fit_iteration_flops(cfg)


def test_full_size_counts():
    """About 460 GFLOP a flagship fit-iteration (77.5 G multiply-adds
    forward, the first convs without an input gradient), 772 for 'kate'."""
    f16 = json.loads((BENCH / "configs" / "skip_denoise_f16.json").read_text())
    kate = json.loads((BENCH / "configs" / "skip_inpaint_kate.json").read_text())
    assert flops.fit_iteration_flops(f16) == pytest.approx(460.07e9, rel=1e-4)
    assert flops.fit_iteration_flops(kate) == pytest.approx(771.80e9, rel=1e-4)


def test_seam_stage_bound():
    """chip_smoke.seam_bound at the top flagship seam (LR 256^2, C=F=128):
    operations bound it at 0.0782 ms in both dtypes."""
    for dtype in ("bfloat16", "float32"):
        for stage in ("fwd", "dgrad", "wgrad"):
            assert flops.seam_stage_ms(stage, 1, 256, 256, 128, 128, dtype) \
                == pytest.approx(2 * 256 * 256 * 9 * 128 * 512 / 989e12 * 1e3)
    # K4 moves the bf16 cotangent (1, 512, 512, 128) in and its pack out: bytes
    assert flops.seam_stage_ms("s2d", 1, 256, 256, 128, 128, "bfloat16") \
        == pytest.approx(2 * 512 * 512 * 128 * 2 / 3.35e12 * 1e3)
