"""Time the seam's data-gradient (K2) and weight-gradient (K3) kernels on
one CUDA card at the seams chip_smoke.py holds them to, beside the one
library call that computes the same function (cuDNN's transposed conv for
K2, its weight gradient for K3) and the bound of each shape.

Two times a call, for the kernel's wrapper and for the library call: `ms`,
the best of three back-to-back loops timed with CUDA events (what a caller
waits, launch costs included: at the small seams the host's pace), and
`device_ms`, the summed device time of the kernels the call launches, from
torch.profiler (what the card spends).

    python3 seam_times.py [--kernel dgrad|wgrad] [--min-steps LIST] [--seam N,h,w,C,F]
                          [--root DIR] [--label NAME] [--out FILE]

`--kernel` may be given twice; without it both kernels are timed.
`--min-steps 3,9,18` times K2 once for each split floor of the list (the
shortest split, in steps, that `hopper_up_conv.dgrad_plan` allows) in
place of the checkout's own floor; each K2 row names its split count.
`--seam` (repeatable) times the given seams in place of the default ones:
the five flagship seams, the ragged seam, the seams that cut the tiles
raggedly and the four 'library' seams (chip_smoke.FLAGSHIP_SEAMS,
RAGGED_SEAM, FWD_RAGGED, LIBRARY_SEAMS), in bf16 and f32, TF32 off. Each
kernel is first held to its plain version at chip_smoke.TOL. `--root DIR`
imports `dip_tpu_torch` from DIR instead of this checkout: a parent commit
unpacked with `git archive` under build/parent/ is then timed by the same
script on the same card (run parent, change, change, parent in one call).
One line a kernel, dtype and shape, then the card line; with `--out` the
rows also go to FILE as JSON. Without a CUDA device it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

import chip_smoke as S


def device_ms(fn, reps: int) -> float:
    """The device time of the kernels one call of `fn` launches, averaged
    over `reps` calls in a torch.profiler window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def time_seam(S, H, name: str, dtype: torch.dtype, seam: tuple, gen, dev, label: str,
              min_steps: int | None = None) -> dict:
    """One row: kernel `name` of the seam module `H` at `seam` in `dtype`,
    held to its plain version, then timed beside its library call."""
    n, h, w, c, f = seam
    xp = torch.randn((n, h + 2, w + 2, c), generator=gen, device=dev).to(dtype)
    e = (torch.randn((3, 3, c, 4 * f), generator=gen, device=dev) * 0.05).to(dtype)
    dzq = torch.randn((n, h, w, 4 * f), generator=gen, device=dev).to(torch.bfloat16)
    carry = torch.randn((n, 2 * h, 2 * w, f), generator=gen, device=dev).to(dtype)
    kern, plain = S.seam_calls(H, xp, e, dzq, carry, dtype)[name]
    library = S.library_calls(xp, e, dzq, carry, dtype)[name]
    rel, _ = S.rel_err(kern(), plain())
    if rel > S.TOL[dtype]:
        raise RuntimeError(f"{name} disagrees with its plain version at {seam} {dtype}: "
                           f"rel {rel:.3e}")
    plan = getattr(H, "dgrad_plan", None)  # a parent checkout may have none
    splits = plan(*seam).splits if name == "dgrad" and plan is not None else None
    reps = 100 if h * w <= 64 * 64 else 30
    ms = min(S.time_ms(kern, reps) for _ in range(3))
    lib_ms = min(S.time_ms(library, reps) for _ in range(3))
    dev_ms, lib_dev_ms = device_ms(kern, reps), device_ms(library, reps)
    bound_ms, by = S.seam_bound(name, n, h, w, c, f, dtype)
    row = {"kernel": name, "dtype": str(dtype)[6:], "seam": list(seam), "ms": ms,
           "device_ms": dev_ms, "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
           "bound_ms": bound_ms, "bound_by": by, "rel_err": rel, "splits": splits,
           "min_steps": min_steps}
    split = "" if splits is None else f" splits {splits}" + (
        "" if min_steps is None else f" (floor {min_steps})")
    print(f"[seam_times] {label} {name} {row['dtype']:8s} N={n} h={h} w={w} C={c} F={f}{split}: "
          f"kernel {ms:.4f} ms (device {dev_ms:.4f}), library {lib_ms:.4f} ms "
          f"(device {lib_dev_ms:.4f}), bound {bound_ms:.4f} ms ({by}), rel {rel:.2e}",
          flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("dgrad", "wgrad"), action="append",
                    help="the kernel to time (repeatable; default both)")
    ap.add_argument("--min-steps", default=None,
                    help="K2 only: comma list of split floors (steps) to time in turn")
    ap.add_argument("--seam", action="append", default=None,
                    help="N,h,w,C,F: time this seam (repeatable) in place of the defaults")
    ap.add_argument("--root", default=None, help="import dip_tpu_torch from this directory")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default=None, help="write the rows to this JSON file")
    args = ap.parse_args()
    kernels = args.kernel or ["dgrad", "wgrad"]
    if not torch.cuda.is_available():
        print("seam_times: no CUDA device", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, str(Path(args.root).resolve()))
    from dip_tpu_torch.bench import card_line
    from dip_tpu_torch.fit.engine import disable_tf32
    from dip_tpu_torch.ops import hopper_up_conv as H

    disable_tf32()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[seam_times] {args.label}: dip_tpu_torch from {Path(H.__file__).parents[2]} | {card}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = ([tuple(int(x) for x in a.split(",")) for a in args.seam] if args.seam else
              S.FLAGSHIP_SEAMS + [S.RAGGED_SEAM] + S.FWD_RAGGED + S.LIBRARY_SEAMS)
    rows = []
    floors = [None] if args.min_steps is None else [int(x) for x in args.min_steps.split(",")]
    if args.min_steps is not None and not hasattr(H, "dgrad_plan"):
        ap.error(f"--min-steps: {H.__file__} has no dgrad_plan")
    for name in kernels:
        for floor in floors if name == "dgrad" else [None]:
            if floor is not None:
                H._DG_MIN_STEPS = floor
                H.dgrad_plan.cache_clear()
            for dtype in (torch.bfloat16, torch.float32):
                for seam in shapes:
                    rows.append(time_seam(S, H, name, dtype, seam, gen, dev, args.label, floor))
    if args.out is not None:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "label": args.label, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
