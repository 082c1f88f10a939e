"""Device idle ms a fit-iteration inside graph replays in the graphed pass: the
gaps between two operations of one replay (dipbench/spans.py)."""

from dipbench.spans import session


def read(run):
    s = session(run)
    return None if s is None else s.bubble_ms
