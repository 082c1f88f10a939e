"""Device idle ms a fit-iteration outside graph replays in the graphed pass:
every gap that is not a bubble, the window's edges included; with the
bubbles, the window's whole idle time (dipbench/spans.py)."""

from dipbench.spans import session


def read(run):
    s = session(run)
    return None if s is None else sum(s.host_gaps.values())
