"""Device ms a fit-iteration of the eager pass's operations that a `dip.batch.*`
span of BatchEngine launched: the per-fit jitter draws and their stacks
(dipbench/spans.py)."""

from dipbench.spans import owned_ms


def read(run):
    return owned_ms(run, lambda owner: owner.startswith("dip.batch."))
