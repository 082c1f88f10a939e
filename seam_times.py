"""Time the seam's data-gradient (K2) and weight-gradient (K3) kernels on
one CUDA card at the seams chip_smoke.py holds them to, the conv weight
gradients (K5, `hopper_wgrad.wgrad3x3_s1`; K6, `hopper_wgrad.wgrad1x1`) at
the calls an inpainting 'kate' step makes, or the downsample (K7,
`hopper_resample.downsample_fused`) at chip_smoke.DOWN_TIMED, beside the one
library call that computes the same function (cuDNN's transposed conv for
K2, its weight gradient for K3, K5 and K6; K7 has none) and the bound of
each shape.

Two times a call, for the kernel's wrapper and for the library call: `ms`,
the best of three back-to-back loops timed with CUDA events (what a caller
waits, launch costs included: at the small seams the host's pace), and
`device_ms`, the summed device time of the kernels the call launches, from
torch.profiler (what the card spends).

    python3 seam_times.py [--kernel dgrad|wgrad|wgrad3x3_s1|wgrad1x1|downsample]
                          [--dtype bfloat16|float32] [--min-steps LIST] [--waves LIST]
                          [--seam N,h,w,C,F] [--down-plan TH,TW,CG] [--reps N]
                          [--root DIR] [--label NAME] [--out FILE]

`--kernel` is repeatable; without it K2 and K3 are timed. Each K2 and K3
row carries a digest of the kernel's output (the inputs come from one
seeded generator in a fixed order), so two checkouts timed by this script
show whether a kernel's bits changed. `--kernel wgrad3x3_s1` and `--kernel
wgrad1x1` first run one step of inpainting 'kate' at 512^2 with
conv_wgrad='all' in each `--dtype` (repeatable, default bfloat16) and record
the shape, strides and halo of each K5 and K6 call (ten K5: x
(1,R+2,R+2,128) and g (1,R,R,128), R from 512 down; eleven K6: the 1x1
skip, up and head convs; NHWC or channel-planar as the step hands them
over), then time the wrapper on seeded inputs of the same shapes, strides
and dtype, layout copies included, with the sum over the step's calls; each
row carries a digest of the output too. The first f32 K5 call at g
(1,512,512,128) also prints the names of the kernels cuDNN runs for it.
`--min-steps 3,9,18` times K2 once for each split floor of the list (the
shortest split, in steps, that `hopper_up_conv.dgrad_plan` allows) in
place of the checkout's own floor; each K2 row names its split count.
`--waves 1,2` times K5 and K6 once for each wave target of the list (the
waves of blocks on the card's SMs that the f32 and the mma split plans aim
at, `hopper_wgrad._F32_WAVES` and `hopper_up_conv._WG_WAVES`) in place of
the checkout's own.
`--kernel downsample` times K7 at SR x4 and x8 (HR 384x576x3) and at the
128-channel post-down of a 512^2 Skip ((1,512,512,128), x2), each held to
downsample_plain at chip_smoke.DOWN_TOL first; each reading is over
`--reps` launches (default 500; at this size one launch reads a few
microseconds). A launch there is shorter than the host's cost of one, so
its rows add `graph_ms`: CUDA events around a CUDA graph of `--reps`
launches (chip_smoke.graph_ms), the device's pace with no host between
launches; the plain version is timed the same way. Each row carries a
digest of the output (the inputs are seeded by the shape, so the digest is
equal across checkouts and plans iff the bits are).
`--down-plan TH,TW,CG` (repeatable) times it once for each tile plan of the
list (output tile rows, columns, channels a block) in place of
`hopper_resample.tile_plan`'s, at the shapes with at least CG channels.
`--seam` (repeatable) times the given seams in place of the default ones:
the five flagship seams, the ragged seam, the seams that cut the tiles
raggedly and the four 'library' seams (chip_smoke.FLAGSHIP_SEAMS,
RAGGED_SEAM, FWD_RAGGED, LIBRARY_SEAMS), in bf16 and f32, TF32 off. Each
kernel is first held to its plain version at chip_smoke.TOL (the weight
gradients at chip_smoke.WGRAD_TOL). `--root DIR` imports `dip_tpu_torch`
from DIR instead of this checkout: a parent commit unpacked with `git
archive` under build/parent/ is then timed by the same script on the same
card (run parent, change, change, parent in one call). One line a kernel,
dtype and shape, then the card line; with `--out` the rows also go to FILE
as JSON. Without a CUDA device it exits 1.
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


WGRAD_KERNELS = ("wgrad3x3_s1", "wgrad1x1")


def kate_wgrad_calls(dtype: torch.dtype) -> dict:
    """{kernel: [(halo, x shape, x strides, g shape, g strides), ...]} of the
    K5 and K6 calls in one step of inpainting 'kate' at 512^2 with
    conv_wgrad='all' in `dtype`, read from the fit of whichever checkout is
    imported."""
    from dip_tpu_torch.bench import _kate
    from dip_tpu_torch.ops import hopper_wgrad as W

    eng, state, aux = _kate(512, "bfloat16" if dtype == torch.bfloat16 else None, "cuda", "all")
    calls = {k: [] for k in WGRAD_KERNELS}
    real3, real1 = W.wgrad3x3_s1, W.wgrad1x1

    def record3(x, g, halo=1):
        calls["wgrad3x3_s1"].append((halo, tuple(x.shape), x.stride(), tuple(g.shape), g.stride()))
        return real3(x, g, halo)

    def record1(x, g):
        calls["wgrad1x1"].append((0, tuple(x.shape), x.stride(), tuple(g.shape), g.stride()))
        return real1(x, g)

    W.wgrad3x3_s1, W.wgrad1x1 = record3, record1
    try:
        eng.step(state, aux)
        torch.cuda.synchronize()
    finally:
        W.wgrad3x3_s1, W.wgrad1x1 = real3, real1
    return calls


def _strided(shape, stride, gen, dev, dtype=torch.bfloat16) -> torch.Tensor:
    """Seeded normal values in a tensor of this shape, strides and dtype."""
    t = torch.empty_strided(shape, stride, dtype=dtype, device=dev)
    t.copy_(torch.randn(shape, generator=gen, device=dev))
    return t


def library_kernels(fn) -> list[str]:
    """The names of the device kernels one call of `fn` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def time_wgrad(S, name: str, dtype: torch.dtype, call: tuple, gen, dev, label: str) -> dict:
    """One row: hopper_wgrad's `name` (wgrad3x3_s1 or wgrad1x1) in `dtype` at
    one recorded call, held to its plain version, timed beside cuDNN's
    weight gradient."""
    from dip_tpu_torch.ops import hopper_wgrad as W

    halo, xs, xst, gs, gst = call
    x, g = _strided(xs, xst, gen, dev, dtype), _strided(gs, gst, gen, dev, dtype)
    layout = ("nhwc" if x.is_contiguous() and g.is_contiguous() else
              "planar" if x.permute(0, 3, 1, 2).is_contiguous() and
              g.permute(0, 3, 1, 2).is_contiguous() else "strided")
    ks = 3 if name == "wgrad3x3_s1" else 1

    def kern():
        return W.wgrad3x3_s1(x, g, halo) if ks == 3 else W.wgrad1x1(x, g)

    def library():
        return torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), (gs[3], xs[3], ks, ks),
                                           g.permute(0, 3, 1, 2), 1, halo)

    want = W.wgrad3x3_s1_plain(x, g, halo) if ks == 3 else W.wgrad1x1_plain(x, g)
    out = kern()
    rel, _ = S.rel_err(out, want)
    lib_rel, _ = S.rel_err(library().permute(2, 3, 1, 0), want)
    tol = S.WGRAD_TOL[dtype]
    if rel > tol or lib_rel > tol:
        raise RuntimeError(f"{name} or cuDNN disagrees with the plain version at {call} {dtype}: "
                           f"rel {rel:.3e}, {lib_rel:.3e}")
    digest = hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()[:16]
    reps = 30 if gs[1] >= 256 else 100
    ms = min(S.time_ms(kern, reps) for _ in range(3))
    lib_ms = min(S.time_ms(library, reps) for _ in range(3))
    dev_ms, lib_dev_ms = device_ms(kern, reps), device_ms(library, reps)
    bound_ms, by = S.wgrad_bound(ks, xs, gs, dtype)
    row = {"kernel": name, "dtype": str(dtype)[6:], "halo": halo, "x": list(xs), "g": list(gs),
           "layout": layout, "ms": ms, "device_ms": dev_ms, "library_ms": lib_ms,
           "library_device_ms": lib_dev_ms, "bound_ms": bound_ms, "bound_by": by,
           "rel_err": rel, "digest": digest}
    print(f"[seam_times] {label} {name} {row['dtype']:8s} halo {halo} {layout:6s} x {xs} g {gs}: "
          f"kernel {ms:.4f} ms (device {dev_ms:.4f}), cudnn {lib_ms:.4f} ms (device "
          f"{lib_dev_ms:.4f}), bound {bound_ms:.4f} ms ({by}), rel {rel:.2e}, digest {digest}",
          flush=True)
    if (ks, dtype, gs) == (3, torch.float32, (1, 512, 512, 128)):
        row["cudnn_kernels"] = library_kernels(library)
        print(f"[seam_times] {label} cudnn kernels of the f32 3x3 weight gradient at x {xs} "
              f"g {gs} (TF32 off): {row['cudnn_kernels']}", flush=True)
    return row


def time_downsample(S, HR, R, case: tuple, gen, dev, label: str, reps: int,
                    plan: tuple | None = None) -> dict:
    """One row: the downsample module `HR` at one chip_smoke.DOWN_CASES
    entry, held to its plain version, then timed (`reps` launches a
    reading) beside it; with `plan` (tile rows, columns, channels) in place
    of HR's own tile plan."""
    shape, factor = case[0], case[1]
    kern, plain, ksize, h_out, w_out = S.down_calls(HR, R, case, gen, dev)
    own = getattr(HR, "tile_plan", None)
    if plan is not None:
        th, tw, cg = plan
        forced = HR.Plan(th, tw, cg, HR.smem_bytes(th, tw, cg, factor, ksize), 0)
        HR.tile_plan = lambda *a: forced
    try:
        out = kern()
        rel, _ = S.rel_err(out, plain())
        if rel > S.DOWN_TOL:
            raise RuntimeError(f"downsample disagrees with its plain version at {case}: "
                               f"rel {rel:.3e}")
        digest = hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()[:16]
        ms = min(S.time_ms(kern, reps) for _ in range(3))
        dev_ms = device_ms(kern, reps)
        g_ms = min(S.graph_ms(kern, reps) for _ in range(3))
        plain_ms = S.graph_ms(plain, max(reps // 10, 10))
        used = (HR.tile_plan(ksize, factor, shape[0], shape[3], h_out, w_out)
                if hasattr(HR, "Plan") else None)
    finally:
        if own is not None:
            HR.tile_plan = own
    bound_ms, by = S.down_bound(shape, ksize, h_out, w_out)
    row = {"kernel": "downsample", "shape": list(shape), "factor": factor, "ksize": ksize,
           "plan": None if used is None else list(used[:3]), "ms": ms, "device_ms": dev_ms,
           "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "rel_err": rel,
           "reps": reps, "digest": digest}
    tiles = "" if used is None else f" tiles {used[0]}x{used[1]}x{used[2]}"
    print(f"[seam_times] {label} downsample {tuple(shape)} x{factor} K={ksize}{tiles}: "
          f"kernel {ms:.5f} ms (device {dev_ms:.5f}, graph {g_ms:.5f}), plain {plain_ms:.4f} "
          f"ms (graph), bound "
          f"{bound_ms:.5f} ms ({by}), rel {rel:.2e}, digest {digest}", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("dgrad", "wgrad") + WGRAD_KERNELS + ("downsample",),
                    action="append",
                    help="the kernel to time (repeatable; default dgrad and wgrad)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), action="append",
                    help="wgrad3x3_s1 / wgrad1x1: the fit's dtype (repeatable; default bfloat16)")
    ap.add_argument("--min-steps", default=None,
                    help="K2 only: comma list of split floors (steps) to time in turn")
    ap.add_argument("--waves", default=None,
                    help="K5 and K6 only: comma list of the split plans' wave targets to time "
                         "in turn")
    ap.add_argument("--seam", action="append", default=None,
                    help="N,h,w,C,F: time this seam (repeatable) in place of the defaults")
    ap.add_argument("--down-plan", action="append", default=None,
                    help="downsample only: TH,TW,CG, a tile plan to time in place of the "
                         "checkout's own (repeatable)")
    ap.add_argument("--reps", type=int, default=500,
                    help="downsample only: launches a reading")
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
    from dip_tpu_torch.ops import hopper_resample as HR
    from dip_tpu_torch.ops import hopper_up_conv as H
    from dip_tpu_torch.ops import hopper_wgrad as W
    from dip_tpu_torch.ops import resample as R

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
    waves = [None] if args.waves is None else [int(x) for x in args.waves.split(",")]
    if args.waves is not None and not hasattr(W, "_F32_WAVES"):
        ap.error(f"--waves: {W.__file__} has no _F32_WAVES")
    own_waves = getattr(W, "_F32_WAVES", None), getattr(H, "_WG_WAVES", None)
    calls = {}  # recorded weight-gradient calls, by dtype
    down_plans = [None] if args.down_plan is None else [
        tuple(int(v) for v in p.split(",")) for p in args.down_plan]
    if args.down_plan is not None and not hasattr(HR, "Plan"):
        ap.error(f"--down-plan: {HR.__file__} has no Plan")
    for name in kernels:
        if name == "downsample":
            for plan, case in [(p, c) for p in down_plans for c in S.DOWN_TIMED]:
                if plan is not None and plan[2] > case[0][3]:
                    continue  # a forced plan applies where its channel group fits
                label = args.label if plan is None else f"{args.label} plan {plan}"
                seeded = torch.Generator(device=dev).manual_seed(S.DOWN_CASES.index(case))
                rows.append(time_downsample(S, HR, R, case, seeded, dev, label, args.reps, plan))
            continue
        if name in WGRAD_KERNELS:
            for dname, wv in [(d, v) for d in args.dtype or ["bfloat16"] for v in waves]:
                dtype = getattr(torch, dname)
                if dtype not in calls:
                    calls[dtype] = kate_wgrad_calls(dtype)
                if wv is not None:
                    W._F32_WAVES, H._WG_WAVES = wv, {9: wv, 1: wv}
                    W.f32_plan.cache_clear()
                    H.wgrad_mma_plan.cache_clear()
                label = args.label if wv is None else f"{args.label} waves {wv}"
                mine = calls[dtype][name]
                print(f"[seam_times] {label}: {len(mine)} {name} calls in a {dname} 'kate' step",
                      flush=True)
                got = [dict(time_wgrad(S, name, dtype, call, gen, dev, label), waves=wv)
                       for call in mine]
                print(f"[seam_times] {label} {name} {dname} a 'kate' step ({len(got)} calls):"
                      f" device {sum(r['device_ms'] for r in got):.4f} ms, caller "
                      f"{sum(r['ms'] for r in got):.4f} ms, cudnn device "
                      f"{sum(r['library_device_ms'] for r in got):.4f} ms, bound "
                      f"{sum(r['bound_ms'] for r in got):.4f} ms", flush=True)
                rows += got
            if args.waves is not None:  # the checkout's own plans for what follows
                W._F32_WAVES, H._WG_WAVES = own_waves
                W.f32_plan.cache_clear()
                H.wgrad_mma_plan.cache_clear()
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
