"""Seconds from the process's start to the window's: imports, the kernel
library, the inputs and weights made from the seed, the eager first step,
the capture and the first steps the correctness check reads (host clock)."""


def read(run):
    return run.setup_s
