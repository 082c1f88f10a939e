"""Device ms a fit-iteration of the eager pass's operations that
`dip.model.pad` owns: the pads (`pad2d`), their
backward included (dipbench/spans.py)."""

from dipbench.spans import owned_ms


def read(run):
    return owned_ms(run, lambda owner: owner == "dip.model.pad")
