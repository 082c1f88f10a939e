"""The decoder seam's share of its roofline in the traced steps: the least
time of every seam stage the steps ran (flops.seam_step_ms, from the
function's shapes, whichever kernels compute it) over the measured time of
the kernels that kernels/seam.*.json maps to the seam."""

from dipbench.flops import seam_step_ms
from dipbench.trace import kernel_maps


def read(run):
    tr = run.trace
    if tr is None:
        return None
    names = kernel_maps(run.checkout / "dipbench").get("seam", {})
    us = sum(b - a for n, a, b in tr.device if any(k in n for k in names))
    least_ms = sum(seam_step_ms(run.cfg, run.fits).values()) * tr.steps
    return 100.0 * least_ms * 1e3 / us if us > 0 and least_ms > 0 else None
