"""Everything a cell is made of is found by name: the committed cells
resolve, and a configuration, a traffic mix, a cell, a metric and a
kernel-name map added as new files run without an edit to any file."""

from __future__ import annotations

import json

from dipbench.harness import cell_metrics, reader
from dipbench.tests.conftest import BENCH, REPO, run_cell, tiny_config, write_limits
from dipbench.trace import Trace, kernel_maps


def test_committed_cells_resolve():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    used = set()
    for w in bench["workloads"]:
        cfg = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
        assert cfg["name"] == w["config"]
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert traffic["engine"] in ("single", "batch")
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        used.add(w["config"])
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reader(REPO, m["name"]))
    assert "up_conv_fwd_mma_kernel" in kernel_maps(BENCH)["seam"]


def test_metric_workloads_key():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x.y"]}],
             "per_layer": [{"name": "c", "workloads": ["x.z"]}]}
    assert [m["name"] for m in cell_metrics(bench, "x.y", False)] == ["a", "b"]
    assert [m["name"] for m in cell_metrics(bench, "x.z", False)] == ["a"]
    assert [m["name"] for m in cell_metrics(bench, "x.z", True)] == ["c"]


def test_new_cell_from_new_files(checkout):
    """A configuration, a traffic mix, a metric reader and limits placed in
    the checkout as new files, and the entries naming them: the run finds
    them all by name."""
    d = checkout / "dipbench"
    cfg = tiny_config("skip_inpaint_kate")
    cfg.update(name="skip_new", precision="bfloat16")
    cfg["net"]["upsample_mode"] = "bilinear"
    (d / "configs" / "skip_new.json").write_text(json.dumps(cfg))
    (d / "traffic" / "pair.json").write_text(json.dumps(
        {"name": "pair", "engine": "batch", "fits": 2, "log_every": 3, "profile_steps": 3,
         "why": "two fits"}))
    (d / "metrics" / "window_iters.py").write_text(
        "def read(run):\n    return float(run.window_fit_iters)\n")
    write_limits(checkout, "new.pair", {"step_gap": 0.9})
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "skip_new", "source": "x", "reduced": [], "why": "x",
                             "file": "dipbench/configs/skip_new.json"})
    bench["workloads"].append({"name": "new.pair", "config": "skip_new", "traffic": "pair",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "window_iters", "unit": "iters", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": ["new.pair"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell(checkout, "new.pair")
    assert r["rc"] == 0, r["stderr"]
    assert r["correct"] is True, r["checks"]
    assert r["metrics"]["window_iters"]["value"] == r["attempted"]
    assert r["attempted"] % 6 == 0  # chunks of 3 steps of 2 fits
    assert set(r["metrics"]) == {"fit_iters_per_s", "peak_mem_gib", "setup_s", "window_iters"}


def test_new_kernel_map(tmp_path):
    """A kernel that computes the seam, mapped by a file of its own, counts
    toward seam_ms."""
    d = tmp_path / "dipbench"
    (d / "kernels").mkdir(parents=True)
    for f in (BENCH / "kernels").iterdir():
        (d / "kernels" / f.name).write_text(f.read_text())
    (d / "kernels" / "seam.other.json").write_text(json.dumps(
        {"function": "seam", "kernels": {"my_seam_fwd_kernel": "fwd"}}))
    (d / "metrics").mkdir()
    (d / "metrics" / "seam_ms.py").write_text((BENCH / "metrics" / "seam_ms.py").read_text())
    from dipbench.harness import Run

    tr = Trace([("void my_seam_fwd_kernel<1>()", 0, 500), ("up_conv_fwd_mma_kernel", 500, 600)],
               [], 1e-3, 1, 1)
    run = Run(tmp_path, {}, 1, 0.0, 1.0, 1, 0, tr)
    assert reader(tmp_path, "seam_ms")(run) == 0.6
