"""The share of the card's peak that the window's fit-iterations reach:
the least time a fit-iteration's model FLOPs take at the peak of the
configuration's precision (flops.least_fit_iteration_s), times the
fit-iterations completed, over the window's wall time. Read from the
untraced window."""

from dipbench.flops import least_fit_iteration_s


def read(run):
    return 100.0 * least_fit_iteration_s(run.cfg) * run.window_fit_iters / run.window_s
