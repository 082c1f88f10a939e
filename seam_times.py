"""Time the seam's data-gradient (K2) and weight-gradient (K3) kernels on
one CUDA card at the seams chip_smoke.py holds them to, or the bf16 3x3
conv weight gradient (K5, `hopper_wgrad.wgrad3x3_s1`) at the calls an
inpainting 'kate' step makes, beside the one library call that computes
the same function (cuDNN's transposed conv for K2, its weight gradient for
K3 and K5) and the bound of each shape.

Two times a call, for the kernel's wrapper and for the library call: `ms`,
the best of three back-to-back loops timed with CUDA events (what a caller
waits, launch costs included: at the small seams the host's pace), and
`device_ms`, the summed device time of the kernels the call launches, from
torch.profiler (what the card spends).

    python3 seam_times.py [--kernel dgrad|wgrad|wgrad3x3_s1] [--min-steps LIST]
                          [--seam N,h,w,C,F] [--root DIR] [--label NAME] [--out FILE]

`--kernel` is repeatable; without it K2 and K3 are timed. Each K2 and K3
row carries a digest of the kernel's output (the inputs come from one
seeded generator in a fixed order), so two checkouts timed by this script
show whether a kernel's bits changed. `--kernel wgrad3x3_s1` first runs
one bf16 step of inpainting 'kate' at 512^2 with conv_wgrad='3x3' and
records the shape, strides and halo of each K5 call (ten: x (1,R+2,R+2,128)
and g (1,R,R,128), R from 512 down, NHWC or channel-planar as the step
hands them over), then times the wrapper on seeded bf16 inputs of the same
shapes and strides, layout copies included.
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
import hashlib
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
    out = kern()
    rel, _ = S.rel_err(out, plain())
    if rel > S.TOL[dtype]:
        raise RuntimeError(f"{name} disagrees with its plain version at {seam} {dtype}: "
                           f"rel {rel:.3e}")
    digest = hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()[:16]
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
           "min_steps": min_steps, "digest": digest}
    split = "" if splits is None else f" splits {splits}" + (
        "" if min_steps is None else f" (floor {min_steps})")
    print(f"[seam_times] {label} {name} {row['dtype']:8s} N={n} h={h} w={w} C={c} F={f}{split}: "
          f"kernel {ms:.4f} ms (device {dev_ms:.4f}), library {lib_ms:.4f} ms "
          f"(device {lib_dev_ms:.4f}), bound {bound_ms:.4f} ms ({by}), rel {rel:.2e}, "
          f"digest {digest}", flush=True)
    return row


def kate_k5_calls() -> list[tuple]:
    """(halo, x shape, x strides, g shape, g strides) of each bf16 K5 call in
    one step of inpainting 'kate' at 512^2 with conv_wgrad='3x3', read from
    the fit of whichever checkout is imported."""
    from dip_tpu_torch.bench import _kate
    from dip_tpu_torch.ops import hopper_wgrad as W

    eng, state, aux = _kate(512, "bfloat16", "cuda")
    eng.model.conv_wgrad = "3x3"
    calls, real = [], W.wgrad3x3_s1

    def record(x, g, halo=1):
        calls.append((halo, tuple(x.shape), x.stride(), tuple(g.shape), g.stride()))
        return real(x, g, halo)

    W.wgrad3x3_s1 = record
    try:
        eng.step(state, aux)
        torch.cuda.synchronize()
    finally:
        W.wgrad3x3_s1 = real
    return calls


def _strided(shape, stride, gen, dev) -> torch.Tensor:
    """Seeded normal bf16 values in a tensor of this shape and these strides."""
    t = torch.empty_strided(shape, stride, dtype=torch.bfloat16, device=dev)
    t.copy_(torch.randn(shape, generator=gen, device=dev))
    return t


def time_k5(S, call: tuple, gen, dev, label: str) -> dict:
    """One row: hopper_wgrad.wgrad3x3_s1 in bf16 at one recorded call, held
    to its plain version, timed beside cuDNN's weight gradient."""
    from dip_tpu_torch.ops import hopper_wgrad as W

    halo, xs, xst, gs, gst = call
    x, g = _strided(xs, xst, gen, dev), _strided(gs, gst, gen, dev)
    layout = ("nhwc" if x.is_contiguous() and g.is_contiguous() else
              "planar" if x.permute(0, 3, 1, 2).is_contiguous() and
              g.permute(0, 3, 1, 2).is_contiguous() else "strided")

    def kern():
        return W.wgrad3x3_s1(x, g, halo)

    def library():
        return torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (gs[3], xs[3], 3, 3),
                                           g.permute(0, 3, 1, 2), 1, halo)

    want = W.wgrad3x3_s1_plain(x, g, halo)
    rel, _ = S.rel_err(kern(), want)
    lib_rel, _ = S.rel_err(library().permute(2, 3, 1, 0), want)
    tol = S.WGRAD_TOL[torch.bfloat16]
    if rel > tol or lib_rel > tol:
        raise RuntimeError(f"wgrad3x3_s1 or cuDNN disagrees with the plain version at {call}: "
                           f"rel {rel:.3e}, {lib_rel:.3e}")
    reps = 30 if gs[1] >= 256 else 100
    ms = min(S.time_ms(kern, reps) for _ in range(3))
    lib_ms = min(S.time_ms(library, reps) for _ in range(3))
    dev_ms, lib_dev_ms = device_ms(kern, reps), device_ms(library, reps)
    bound_ms, by = S.wgrad_bound(3, xs, gs, torch.bfloat16)
    row = {"kernel": "wgrad3x3_s1", "dtype": "bfloat16", "halo": halo, "x": list(xs),
           "g": list(gs), "layout": layout, "ms": ms, "device_ms": dev_ms, "library_ms": lib_ms,
           "library_device_ms": lib_dev_ms, "bound_ms": bound_ms, "bound_by": by,
           "rel_err": rel}
    print(f"[seam_times] {label} wgrad3x3_s1 bfloat16 halo {halo} {layout:6s} x {xs} g {gs}: "
          f"kernel {ms:.4f} ms (device {dev_ms:.4f}), cudnn {lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f}), bound {bound_ms:.4f} ms ({by}), rel {rel:.2e}", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("dgrad", "wgrad", "wgrad3x3_s1"), action="append",
                    help="the kernel to time (repeatable; default dgrad and wgrad)")
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
        if name == "wgrad3x3_s1":
            calls = kate_k5_calls()
            print(f"[seam_times] {args.label}: {len(calls)} K5 calls in a 'kate' step", flush=True)
            k5 = [time_k5(S, call, gen, dev, args.label) for call in calls]
            print(f"[seam_times] {args.label} wgrad3x3_s1 a 'kate' step ({len(k5)} calls): "
                  f"device {sum(r['device_ms'] for r in k5):.4f} ms, caller "
                  f"{sum(r['ms'] for r in k5):.4f} ms, cudnn device "
                  f"{sum(r['library_device_ms'] for r in k5):.4f} ms", flush=True)
            rows += k5
            continue
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
