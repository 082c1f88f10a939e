"""The trace arithmetic on synthetic intervals: the union of overlapping
device operations, the idle gaps and what the host did in them, kernel
kinds, and the per-layer readers on such a trace."""

from __future__ import annotations

import json

import pytest

from dipbench import flops
from dipbench.harness import Run, reader
from dipbench.tests.conftest import BENCH, REPO
from dipbench.trace import Trace, idle_gaps, kernel_maps, kind_ms, kind_of, merged, union_us

SEAM_FWD = "void up_conv_fwd_mma_kernel<__nv_bfloat16, false, 1>(Params)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, add>(int)"
CUDNN = "sm90_xmma_fprop_implicit_gemm_bf16_cudnn"


def _trace(device, host=(), wall_s=1e-3, steps=1, fit_iters=1) -> Trace:
    return Trace(list(device), list(host), wall_s, steps, fit_iters)


def test_union_counts_overlaps_once():
    ivs = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 32, 35), ("e", 40, 41)]
    assert merged(ivs) == [(0, 20), (30, 41)]
    assert union_us(ivs) == 31
    # two streams that overlap entirely: the sum of the kernel times would say 200
    assert union_us([("s1", 0, 100), ("s2", 0, 100)]) == 100


def test_idle_gaps_name_the_innermost_host_op():
    tr = _trace([("k", 0, 10), ("k", 30, 40), ("k", 41, 50)],
                host=[("aten::copy_", 5, 35), ("cudaStreamSynchronize", 12, 29)])
    gaps = idle_gaps(tr)
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(20e-6)]
    assert gaps[1] == ["host python", pytest.approx(1e-6)]


def test_kinds_port_first_then_table():
    kinds = json.loads((BENCH / "kernels" / "kinds.json").read_text())["kinds"]
    port = set(kernel_maps(BENCH)["seam"])
    assert kind_of(SEAM_FWD, port, kinds) == "port"
    assert kind_of(ELEMENTWISE, port, kinds) == "elementwise"
    assert kind_of(CUDNN, port, kinds) == "library"
    # cuBLAS's gemv under cuDNN's f32 FFT convolution
    assert kind_of("void gemv2N_kernel<int, float2, cublasGemvParamsEx<int> >(T)", port,
                   kinds) == "library"
    assert kind_of("void something_else()", port, kinds) == "other"
    tr = _trace([(ELEMENTWISE, 0, 300), (CUDNN, 300, 400), (SEAM_FWD, 400, 500)], fit_iters=2)
    assert kind_ms(tr, BENCH, "elementwise") == pytest.approx(0.15)
    assert kind_ms(tr, BENCH, "library") == pytest.approx(0.05)
    assert kind_ms(_trace([]), BENCH, "library") is None


def _run(cfg, tr, fits=1) -> Run:
    return Run(REPO, cfg, fits, 1.0, 10.0, 100, 0, tr)


def test_layer_readers_on_a_synthetic_trace():
    cfg = json.loads((BENCH / "configs" / "skip_denoise_f16.json").read_text())
    # two streams, 0.6 of the wall busy: 0.4 idle
    tr = _trace([(CUDNN, 0, 400), (ELEMENTWISE, 200, 600)], wall_s=1e-3)
    assert reader(REPO, "device_idle")(_run(cfg, tr)) == pytest.approx(40.0)
    assert reader(REPO, "seam_ms")(_run(cfg, tr)) is None
    assert reader(REPO, "seam_roofline")(_run(cfg, tr)) is None
    assert reader(REPO, "device_idle")(_run(cfg, _trace([]))) is None
    # seam kernels that take twice their least time read 50 %
    least_us = sum(flops.seam_step_ms(cfg, 1).values()) * 1e3 * 3
    tr = _trace([(SEAM_FWD, 0, 2 * least_us)], steps=3, fit_iters=3)
    assert reader(REPO, "seam_roofline")(_run(cfg, tr)) == pytest.approx(50.0)
    assert reader(REPO, "seam_ms")(_run(cfg, tr)) == pytest.approx(2 * least_us / 3e3)


def test_mfu_from_the_window():
    cfg = json.loads((BENCH / "configs" / "skip_denoise_f16.json").read_text())
    run = _run(cfg, None)  # 100 fit-iterations in 10 s
    want = 100 * flops.least_fit_iteration_s(cfg) * 100 / 10.0
    assert reader(REPO, "mfu")(run) == pytest.approx(want)
    assert reader(REPO, "fit_iters_per_s")(run) == pytest.approx(10.0)
