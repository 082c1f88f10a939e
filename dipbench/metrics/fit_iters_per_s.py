"""Fit-iterations completed in the window, summed over the fits, over the
window's wall time (host clock, from the end of set-up to the sync after
the last chunk that started inside --seconds)."""


def read(run):
    return run.window_fit_iters / run.window_s
