"""Tracing and timing hooks (counterpart of dip_tpu/utils/profiling.py):
`span(name)` marks a piece of the program's work, `tracing()` turns the
spans on, `trace()` records a block with torch.profiler (spans on) and
writes a Chrome trace (chrome://tracing, Perfetto), `timed_chunk` times a
call with the device synchronised, and `enable_nan_debug()` turns on
autograd's anomaly mode.

Spans are named `dip.<layer>.<what>`: `dip.fit.*` (fit/engine.py),
`dip.batch.*` (parallel/batch.py), `dip.model.*` (models/blocks.py,
ops/pad.py, ops/resample.py) and `dip.kernels.seam` (ops/up_conv.py). On,
a span is a `torch.profiler.record_function`, so a profiler sees it in the
same timeline as the device's kernels, with the correlation ids that link
each kernel to the innermost span open when it was launched. Off (the
default, and whenever only a profiler outside the program runs), a span
is one shared no-op context: no record, no allocation, nothing added to a
captured CUDA graph.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_on = False


def span(name: str):
    """A context that marks its block as `name` while tracing is on, and
    does nothing otherwise: `with span("dip.model.conv"): ...`."""
    return record_function(name) if _on else _OFF


@contextlib.contextmanager
def tracing():
    """Turn the spans on for the block (and back to what they were after)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block, CPU and (where there is one) CUDA activity, with
    the spans on, and write `log_dir`/trace.json:
    `with trace('dip-trace'): run_task(...)`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, tracing():
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_debug() -> None:
    """Opt-in NaN checks: autograd's anomaly mode names the forward op of a
    backward that makes a NaN (debug runs only: it slows every step)."""
    torch.autograd.set_detect_anomaly(True)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed_chunk(fn, *args, warmup: int = 1, repeats: int = 3) -> float:
    """Median wall-clock seconds of fn(*args) after `warmup` calls, the
    device synchronised before the clock is read (PyTorch returns before a
    CUDA device finishes)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
