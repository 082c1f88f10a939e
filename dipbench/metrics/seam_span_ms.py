"""Device ms a fit-iteration of the eager pass's operations that
`dip.kernels.seam` owns: the seam kernels K1-K4 and the seam's own torch ops
(the edge-pad cats, the reflection corrections, `up2_moments`), their
backward included (dipbench/spans.py)."""

from dipbench.spans import owned_ms


def read(run):
    return owned_ms(run, lambda owner: owner == "dip.kernels.seam")
