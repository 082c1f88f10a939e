"""The readings a cell's correctness limits are set from, at the cell's own
sizes on the card (no measured window: the check reads the first steps):

  program   the port's first steps against the reference, one run a seed
  control   the reference put in the program's place, computed in the
            precision below the configuration's (fp8 operands below bf16),
            against the reference
  frozen    the reference in the program's place with a step that leaves
            its state unchanged
  dropped   (several fits) the reference in the program's place with the
            last half of the fits left out of the loss
  bf16      a look at what rounding alone does to each number: the
            reference with its conv operands rounded to bf16
  ulp       the same for the least rounding: the reference from weights
            nudged by one f32 ulp, up or down as drawn from the seed

    python3 dipbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--look-seeds 10,11] \
        [--out chiprun_out/x.json]

Prints one JSON line per run and, last, each number's largest program
reading and smallest reading of each of the others.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[0] = str(CHECKOUT)

import torch  # noqa: E402

from dipbench import check, harness, inputs  # noqa: E402


def _ints(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def _nudged(weights: dict, seed: int) -> dict:
    """Each weight moved by one f32 ulp, up or down as drawn from `seed`."""
    gen = torch.Generator(device=next(iter(weights.values())).device).manual_seed(seed)
    out = {}
    for k, w in weights.items():
        up = torch.rand(w.shape, generator=gen, device=w.device) < 0.5
        out[k] = torch.nextafter(w, torch.where(up, torch.inf, -torch.inf))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--look-seeds", type=_ints, default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = harness.load(CHECKOUT, "configs", cell["config"])
    traffic = harness.load(CHECKOUT, "traffic", cell["traffic"])
    fits = traffic["fits"]
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# card: {harness.card_line()}", flush=True)
    from dipbench.program import Program

    rows = []

    def emit(kind: str, seed: int, got: tuple[dict, dict], seconds: float) -> None:
        values, worst_at = got
        row = {"kind": kind, "seed": seed, **values, "at": worst_at, "ref_s": seconds}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def reference(seed: int, nudge: bool = False, **kw) -> tuple[dict, float]:
        t = time.perf_counter()
        made = inputs.make(cfg, fits, seed, dev)
        if nudge:
            made = dataclasses.replace(made, weights=_nudged(made.weights, seed))
        r = check.reference_readings(cfg, made, dev, **kw)
        return r, time.perf_counter() - t

    for seed in args.seeds:
        made = inputs.make(cfg, fits, seed, dev)
        program = Program(cfg, traffic, made, dev)
        prog = check.program_readings(program, made.weights)
        del program, made
        gc.collect()
        torch.cuda.empty_cache()
        ref, secs = reference(seed)
        emit("program", seed, check.gaps(prog, ref), secs)
    for seed in args.control_seeds:
        ref, _ = reference(seed)
        ctl, secs = reference(seed, **check.control(cfg))
        emit("control", seed, check.gaps(ctl, ref), secs)
    for seed in args.fault_seeds:
        ref, _ = reference(seed)
        emit("frozen", seed, check.gaps(reference(seed, frozen=True)[0], ref), 0.0)
        if fits > 1:
            emit("dropped", seed, check.gaps(reference(seed, dropped=fits // 2)[0], ref), 0.0)
    for seed in args.look_seeds:
        ref, _ = reference(seed)
        emit("bf16", seed, check.gaps(reference(seed, operands="bf16")[0], ref), 0.0)
        emit("ulp", seed, check.gaps(reference(seed, nudge=True)[0], ref), 0.0)

    summary = {}
    for kind in ("program", "control", "frozen", "dropped", "bf16", "ulp"):
        got = [r for r in rows if r["kind"] == kind]
        if got:
            pick = max if kind in ("program", "bf16", "ulp") else min
            summary[kind] = {k: pick(r[k] for r in got) for k in check.CHECKS if k in got[0]}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "seconds": time.perf_counter() - T0}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
