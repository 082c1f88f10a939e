"""The share of the traced steps' wall time in which no operation ran on
the card: 1 - (the union of the device operations' intervals) / (the wall
time), so that operations overlapping on streams count once."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
