"""A configuration's task, one module each, found by the configuration's
`task` key: `images(img, fits, seed, gen, device)` makes its target on the
card, `reference_loss(out, aux)` is its plain loss, and `program_fns()`
gives the port's own loss and metrics for `Engine` and `BatchEngine`."""

import importlib


def load(name: str):
    return importlib.import_module(f"dipbench.tasks.{name}")
