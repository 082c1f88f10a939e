"""Device ms a fit-iteration of the eager pass's operations that
`dip.model.bn` owns: the norms (`TrainBatchNorm`, `InstanceNorm`), their
backward included (dipbench/spans.py)."""

from dipbench.spans import owned_ms


def read(run):
    return owned_ms(run, lambda owner: owner == "dip.model.bn")
