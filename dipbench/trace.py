"""The device trace of a traced run: torch.profiler over a fixed number of
steps, reduced to the device's operations (kernels, copies, sets) and the
host's, each as (name, start_us, end_us), with the arithmetic the
per-layer readers share: the union of intervals, the idle gaps and what
the host was doing in each, and kernel time by kind."""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable

Interval = tuple[str, float, float]  # name, start, end (microseconds)


@dataclasses.dataclass
class Trace:
    device: list[Interval]  # every operation the card ran
    host: list[Interval]    # the host's recorded operations
    wall_s: float           # host wall time of the traced steps, ending in a sync
    steps: int              # steps traced (batched steps count once)
    fit_iters: int          # fit-iterations traced

    @property
    def busy_s(self) -> float:
        return union_us(self.device) * 1e-6


def record(fn: Callable[[], object], steps: int, fit_iters: int) -> Trace:
    """Run fn under torch.profiler (CPU and CUDA activity); fn's work ends in
    a device sync inside the timed span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        iv = (e.name, float(e.time_range.start), float(e.time_range.end))
        (device if e.device_type == torch.autograd.DeviceType.CUDA else host).append(iv)
    return Trace(device, host, wall, steps, fit_iters)


def merged(intervals: list[Interval]) -> list[tuple[float, float]]:
    """The union of the intervals as sorted, disjoint (start, end) pairs."""
    out: list[list[float]] = []
    for _, a, b in sorted(intervals, key=lambda iv: iv[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_us(intervals: list[Interval]) -> float:
    """Microseconds in which at least one of the intervals runs."""
    return sum(b - a for a, b in merged(intervals))


def idle_gaps(trace: Trace, top: int = 10) -> list[list]:
    """The `top` longest gaps between device operations, each [what the host
    was doing, seconds]: the innermost host operation that spans the gap's
    middle (the latest to start), or 'host python' where none does."""
    spans = merged(trace.device)
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:]) if a1 > b0),
                  key=lambda g: g[0] - g[1])[:top]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        over = [iv for iv in trace.host if iv[1] <= mid <= iv[2]]
        name = max(over, key=lambda iv: iv[1])[0] if over else "host python"
        out.append([short(name), (b - a) * 1e-6])
    return out


def top_ops(trace: Trace, top: int = 10) -> list[list]:
    """The `top` device operations by their total time, [name, seconds]."""
    total: dict[str, float] = {}
    for name, a, b in trace.device:
        total[name] = total.get(name, 0.0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[short(name), us * 1e-6] for name, us in ranked]


def short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


# -- kernel names ------------------------------------------------------------------

def kernel_maps(root: Path) -> dict[str, dict[str, str]]:
    """function -> {kernel name: stage} over every kernels/<function>.<impl>.json."""
    maps: dict[str, dict[str, str]] = {}
    for path in sorted((root / "kernels").glob("*.*.json")):
        data = json.loads(path.read_text())
        maps.setdefault(data["function"], {}).update(data["kernels"])
    return maps


def kind_of(name: str, port: set[str], kinds: list) -> str:
    """'port' for a name holding one of the port's kernel names, else the
    first kind of kernels/kinds.json one of whose substrings it holds, else
    'other'."""
    if any(k in name for k in port):
        return "port"
    return next((kind for kind, subs in kinds if any(s in name for s in subs)), "other")


def kind_ms(trace: Trace, root: Path, kind: str) -> float | None:
    """Device ms a fit-iteration of the kernels of `kind`; None without a
    device operation to read."""
    if not trace.device:
        return None
    port = {k for m in kernel_maps(root).values() for k in m}
    kinds = json.loads((root / "kernels" / "kinds.json").read_text())["kinds"]
    us = sum(b - a for name, a, b in trace.device if kind_of(name, port, kinds) == kind)
    return us * 1e-3 / trace.fit_iters
