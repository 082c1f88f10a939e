"""Device operations a fit-iteration in the graphed pass: every kernel, copy
and set in the profiled window of `profile_steps` steps (graph replays and
the chunk edge's own), over its fit-iterations (dipbench/spans.py)."""

from dipbench.spans import session


def read(run):
    s = session(run)
    return None if s is None else s.graphed_ops / s.graphed_fit_iters
