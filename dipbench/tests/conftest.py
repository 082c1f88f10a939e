"""A tiny checkout for the CPU tests: the benchmark's readers, kernel maps
and traffic, with configurations cut to 32 x 32 images and 8 channels (a
size the CPU runs in seconds), and limits for that size."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "dipbench"
TINY_LIMITS = {"step_gap": 0.9, "grad_gap": 0.9, "step_med": 0.9, "grad_med": 0.9}


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["image"].update(height=32, width=32)
    net = cfg["net"]
    net.update(num_input_channels=4, num_channels_down=[8] * 3, num_channels_up=[8] * 3,
               num_channels_skip=[min(net["num_channels_skip"][0], 8)] * 3)
    cfg["input"]["depth"] = 4
    return cfg


def write_limits(path: Path, workload: str, limits: dict) -> None:
    from dipbench.check import CHECKS

    data = {k: {"limit": limits.get(k)} for k in CHECKS}
    data["nonfinite"] = {"limit": 0}
    (path / "dipbench" / "limits").mkdir(parents=True, exist_ok=True)
    (path / "dipbench" / "limits" / f"{workload}.json").write_text(json.dumps(data))


@pytest.fixture
def checkout(tmp_path: Path) -> Path:
    """A checkout with BENCHMARK.json's cells at the tiny size."""
    root = tmp_path / "checkout"
    for sub in ("metrics", "kernels", "traffic"):
        shutil.copytree(BENCH / sub, root / "dipbench" / sub)
    (root / "dipbench" / "configs").mkdir()
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = tiny_config(c["name"])
        (root / "dipbench" / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for t in ("single", "batch8"):
        path = root / "dipbench" / "traffic" / f"{t}.json"
        traffic = json.loads(path.read_text())
        traffic.update(log_every=4, profile_steps=4, fits=min(traffic["fits"], 2),
                       warm_seconds=0.01)
        path.write_text(json.dumps(traffic))
    for w in bench["workloads"]:
        write_limits(root, w["name"], TINY_LIMITS)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(checkout: Path, workload: str, seed: int = 3000000019, setup: str = "") -> dict:
    """One run of `workload` on the CPU in a fresh process (so that no module
    a test process loaded counts against it), `setup` run first there (a
    planted fault); its result line as a dict, with `rc`."""
    code = (f"import sys, time\nsys.path.insert(0, {str(REPO)!r})\n{setup}\n"
            "from pathlib import Path\nfrom dipbench import harness\n"
            f"sys.exit(harness.main(['--workload', {workload!r}, '--seed', '{seed}', "
            f"'--seconds', '0.5'], Path({str(checkout)!r}), time.perf_counter(), device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
    result["rc"], result["stderr"] = proc.returncode, proc.stderr[-3000:]
    return result
