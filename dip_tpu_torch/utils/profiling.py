"""Tracing and timing hooks (counterpart of dip_tpu/utils/profiling.py):
`trace()` records a block with torch.profiler and writes a Chrome trace
(chrome://tracing, Perfetto), `timed_chunk` times a call with the device
synchronised, and `enable_nan_debug()` turns on autograd's anomaly mode.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block, CPU and (where there is one) CUDA activity, and
    write `log_dir`/trace.json: `with trace('dip-trace'): run_task(...)`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
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
