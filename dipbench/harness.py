"""One run of one cell: set-up, the first steps that the correctness check
reads, the measured window, the traced steps (with --trace 1), the memory
peak, the reference, and the result line.

Everything a cell is made of is found by name under the checkout: its
configuration `dipbench/configs/<config>.json`, its traffic
`dipbench/traffic/<traffic>.json`, its limits `dipbench/limits/<workload>.json`,
each metric's reader `dipbench/metrics/<metric>.py` (a function
`read(run) -> float | None` of a `Run`), and the kernel-name maps
`dipbench/kernels/<function>.<implementation>.json`.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from dipbench import check, inputs
from dipbench.trace import Trace, idle_gaps, record, top_ops

# top-level module names that must not be loaded (compared whole: the
# port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dip_tpu")


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    checkout: Path
    cfg: dict
    fits: int
    setup_s: float
    window_s: float          # the measured window's wall time
    window_fit_iters: int    # fit-iterations completed in it, over every fit
    peak_bytes: int          # torch.cuda.max_memory_allocated over set-up and window
    trace: Trace | None      # the traced steps (--trace 1)


def load(checkout: Path, kind: str, name: str) -> dict:
    return json.loads((checkout / "dipbench" / kind / f"{name}.json").read_text())


def reader(checkout: Path, metric: str):
    path = checkout / "dipbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"dipbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` reports: the end-to-end ones, or with
    a trace the per-layer ones, each where its `workloads` (if given) list it."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"{torch.cuda.get_device_name(0)}, power limit not read ({e})"


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a whole number from 0")
    return args


def main(argv: list[str], checkout: Path, t0: float, device: str | None = None) -> int:
    """Run a cell and print its result as the last line of stdout; the
    numbers compared, each beside its limit, as the last lines of stderr.
    `device` None asks for the card the cell needs (exit 2 without it); the
    tests pass 'cpu'."""
    args = parse(argv)
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        print(f"# card: {card_line()}", flush=True)
    dev = torch.device(device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load(checkout, "configs", cell["config"])
    traffic = load(checkout, "traffic", cell["traffic"])
    fits, log_every = traffic["fits"], traffic["log_every"]

    from dipbench.program import Program, fit_iters

    marks = [time.perf_counter()]
    made = inputs.make(cfg, fits, args.seed, dev)
    _sync(dev)
    marks.append(time.perf_counter())
    program = Program(cfg, traffic, made, dev)
    marks.append(time.perf_counter())
    prog_readings = check.program_readings(program, made.weights)
    del made
    marks.append(time.perf_counter())
    print(f"# set-up seconds: imports {marks[0] - t0:.3f}, inputs {marks[1] - marks[0]:.3f}, "
          f"program {marks[2] - marks[1]:.3f}, first steps {marks[3] - marks[2]:.3f}",
          file=sys.stderr)

    # warm-up chunks, counted in set-up: for the first tens of seconds of a
    # process each launch of a step can cost the card a millisecond more, so
    # a traffic mix may ask for `warm_seconds` of whole chunks before the window
    _sync(dev)
    warm_start, warm_ends = time.perf_counter(), []
    while time.perf_counter() - warm_start < traffic.get("warm_seconds", 0):
        program.run(log_every)
        warm_ends.append(time.perf_counter() - warm_start)
    if warm_ends:
        print("# warm-up chunk seconds: " + " ".join(
            f"{b - a:.4f}" for a, b in zip([0.0] + warm_ends, warm_ends)), file=sys.stderr)

    # the window: whole chunks, the last one started inside --seconds
    _sync(dev)
    start = time.perf_counter()
    setup_s = start - t0
    done = failed = 0
    ends = []
    while True:
        n, bad = fit_iters(program.run(log_every))
        done, failed = done + n, failed + bad
        ends.append(time.perf_counter() - start)
        if ends[-1] >= args.seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - start
    print("# chunk seconds: " + " ".join(f"{b - a:.4f}" for a, b in zip([0.0] + ends, ends)),
          file=sys.stderr)
    traced = None
    if args.trace:
        p = traffic["profile_steps"]
        traced = record(lambda: program.run(p), p, p * fits)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.reference_readings(cfg, inputs.make(cfg, fits, args.seed, dev), dev)
    values, worst_at = check.gaps(prog_readings, ref)
    values["nonfinite"] = failed
    correct, table = check.judge(values, check.limits(checkout, args.workload))

    run = Run(checkout, cfg, fits, setup_s, window_s, done, peak, traced)
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        value = reader(checkout, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": done, "failed": failed, "metrics": metrics,
              "device": device_info}
    if traced is not None:
        device_info.update(busy_s=traced.busy_s, window_s=traced.wall_s)
        result["breakdown"] = {"device_ops": top_ops(traced), "idle_gaps": idle_gaps(traced)}
    result["checks"] = table
    for name, v in table.items():
        ok = ("not compared" if v["limit"] is None else
              "ok" if v["value"] <= v["limit"] else "OVER")
        at = f" (at {worst_at[name]})" if name in worst_at else ""
        print(f"check {name} {v['value']!r}{at} limit {v['limit']!r} {ok}", file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr, flush=True)
    # last of all, after every reader has been loaded and has run
    bad_modules = forbidden_modules()
    if bad_modules:
        print(f"modules that must not be loaded are: {bad_modules}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
