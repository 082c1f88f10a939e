"""The benchmark's yardstick: the operations a fit-iteration needs, the
least time of the decoder seam's kernels, and the card's published peaks.

A fit-iteration's FLOPs are those of every conv of the configuration's
plain reference, counted from shapes: the forward, the input gradient
(left out where the input is the net's input z, which needs none) and the
weight gradient, 2 FLOPs a multiply-add each, nothing recomputed, all
charged at the peak of the precision the configuration states. The
seam's bound is a frozen copy of chip_smoke.py's `bound` and
`seam_bound`, with K4's pack beside them.
"""

from __future__ import annotations

from dipbench.inputs import reference_net

# NVIDIA H100 SXM, dense, at its 700 W limit: bf16 on the tensor cores and
# f32 off them (TF32 is off); HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


def _size(cfg: dict) -> tuple[int, int]:
    return cfg["image"]["height"], cfg["image"]["width"]


def fit_iteration_flops(cfg: dict) -> float:
    """FLOPs of one fit-iteration."""
    total = 0.0
    for s in reference_net(cfg).convs(cfg["net"], *_size(cfg)):
        passes = 2 if s.reads_input else 3
        cin = sum(c for c, _ in s.parts)
        total += 2.0 * s.h_out * s.w_out * s.cout * cin * s.k * s.k * passes
    return total


def least_fit_iteration_s(cfg: dict) -> float:
    """The least time a fit-iteration's FLOPs take at the card's peak."""
    return fit_iteration_flops(cfg) / PEAK_FLOPS[cfg["precision"]]


def bound_ms(ops: float, nbytes: float) -> float:
    """Least ms of `ops` tensor-core bf16 operations against `nbytes` moved
    once at the memory rate (chip_smoke.bound)."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["bfloat16"]) * 1e3


def seam_stage_ms(stage: str, n: int, h: int, w: int, c: int, f: int, dtype: str,
                  fits: int = 1) -> float:
    """Least ms of one seam stage at LR (N, h, w, C) -> F: fwd (K1), s2d (K4),
    dgrad (K2), wgrad (K3). 2*N*h*w*9*C*4F tensor-core operations (bf16 in
    both modes) for K1-K3; each input read and each output written once:
    xp, out and de in `dtype`, dzq bf16; with the fit axis, N counts every
    fit's images and e (or de) is `fits` kernels (chip_smoke.seam_bound).
    K4 reads the HR cotangent in `dtype` and writes dzq."""
    s = BYTES[dtype]
    xp = n * (h + 2) * (w + 2) * c * s
    e = fits * 9 * c * 4 * f * s
    dzq = n * h * w * 4 * f * 2
    z = n * 4 * h * w * f * s
    if stage == "s2d":
        return bound_ms(0.0, z + dzq)
    nbytes = {"fwd": xp + e + z, "dgrad": dzq + e + xp, "wgrad": xp + dzq + e}[stage]
    return bound_ms(2.0 * n * h * w * 9 * c * 4 * f, nbytes)


def seam_levels(cfg: dict) -> list[tuple[int, int, int, int]]:
    """(h, w, C, F) at LR of every fused decoder seam of one fit."""
    out = []
    for s in reference_net(cfg).convs(cfg["net"], *_size(cfg)):
        for cin, kind in s.parts:
            if kind == "seam":
                out.append((s.h_out // 2, s.w_out // 2, cin, s.cout))
    return out


def seam_step_ms(cfg: dict, fits: int) -> dict[str, float]:
    """Least ms of each seam stage over one step of `fits` fits (one image
    each, one launch of each stage a seam for all of them)."""
    dtype = cfg["precision"]
    out: dict[str, float] = {}
    for h, w, c, f in seam_levels(cfg):
        for stage in ("fwd", "s2d", "dgrad", "wgrad"):
            out[stage] = out.get(stage, 0.0) + seam_stage_ms(stage, fits, h, w, c, f, dtype,
                                                             fits)
    return out
