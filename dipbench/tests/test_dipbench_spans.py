"""The span readers (dipbench/spans.py): nothing read and nothing built
without a device trace; on the card (`cuda`), a session of each engine at
the tiny size whose owners cover the eager pass and whose bubbles and
host gaps make up the graphed window's idle time."""

from __future__ import annotations

import json

import pytest

from dipbench import spans
from dipbench.harness import Run, reader
from dipbench.tests.conftest import REPO, tiny_config
from dipbench.trace import Trace

SPAN_METRICS = ("fit_span_ms", "batch_span_ms", "conv_span_ms", "bn_span_ms", "act_span_ms",
                "pad_span_ms", "seam_span_ms", "kernels_per_iter", "graph_bubble_ms",
                "host_gap_ms")


def test_every_span_metric_is_in_the_benchmark():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert m["source"] == "device_trace" and m["moves"] == "fit_iters_per_s"
        assert m["workloads"], name


@pytest.mark.parametrize("trace", [None, Trace([], [], 1.0, 1, 1)], ids=["untraced", "cpu"])
def test_span_readers_read_nothing_without_a_device_trace(trace):
    before = dict(spans._SESSIONS)
    run = Run(REPO, tiny_config("skip_denoise_f16"), 1, 1.0, 1.0, 1, 0, trace)
    for name in SPAN_METRICS:
        assert reader(REPO, name)(run) is None, name
    assert spans._SESSIONS == before


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["f16_denoise.single", "kate_inpaint.batch8"])
def test_session_on_the_card(checkout, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = json.loads((checkout / "dipbench" / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((checkout / "dipbench" / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    s = spans._record(Run(checkout, cfg, traffic["fits"], 1.0, 1.0, 1, 0, None))
    owned = sum(s.owners.values())
    assert owned >= s.eager_busy_ms * 0.99
    assert s.owners.get(spans.UNATTRIBUTED, 0.0) <= 0.05 * owned
    assert {"dip.model.conv", "dip.model.bn", "dip.kernels.seam"} <= set(s.owners)
    assert s.replayed > 0.9 * s.graphed_ops  # the chunk edge's own operations aside
    gaps = s.bubble_ms + sum(s.host_gaps.values())
    assert gaps == pytest.approx(s.graphed_idle_ms, rel=0.02)
    assert s.graphed_ops > 0 and s.replay_host_us is not None
