"""Device ms a fit-iteration of the decoder seam: every kernel that a
kernels/seam.*.json map names, in the traced steps."""

from dipbench.trace import kernel_maps


def read(run):
    tr = run.trace
    if tr is None:
        return None
    names = kernel_maps(run.checkout / "dipbench").get("seam", {})
    us = sum(b - a for n, a, b in tr.device if any(k in n for k in names))
    return us * 1e-3 / tr.fit_iters if us > 0 else None
