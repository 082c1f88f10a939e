"""Device ms a fit-iteration of the eager pass's operations that a `dip.fit.*`
span of the fit engine launched: jitter, casts, the forward's and backward's
own ops, the loss, Adam, the EMA, the metrics (dipbench/spans.py)."""

from dipbench.spans import owned_ms


def read(run):
    return owned_ms(run, lambda owner: owner.startswith("dip.fit."))
