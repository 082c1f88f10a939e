"""torch.cuda.max_memory_allocated over set-up and the window, read before
anything of the reference runs, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
