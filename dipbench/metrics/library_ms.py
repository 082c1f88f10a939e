"""Device ms a fit-iteration of cuDNN's and cuBLAS's kernels in the traced
steps (kernels/kinds.json)."""

from dipbench.trace import kind_ms


def read(run):
    return None if run.trace is None else kind_ms(run.trace, run.checkout / "dipbench",
                                                  "library")
