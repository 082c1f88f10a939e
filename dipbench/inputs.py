"""The inputs of a cell, made from the run's seed on the device: each fit's
weights, its input z, its image (and mask), and the seed of its jitter
stream. The same seed gives the same inputs; every seed gives the same
sizes. The program and the reference are handed the same tensors."""

from __future__ import annotations

import dataclasses
import importlib
import math

import torch

from dipbench import tasks

# fit i of a run with seed s is started as `init_state(s * FITS_A_SEED + i)`
FITS_A_SEED = 4096


def reference_net(cfg: dict):
    """The configuration's plain reference net: dipbench/reference/<reference>.py."""
    return importlib.import_module(f"dipbench.reference.{cfg['reference']}")


def fit_seed(seed: int, i: int) -> int:
    """The seed fit i of a run hands the program's init_state."""
    return seed * FITS_A_SEED + i


def jitter_seed(seed_of_fit: int) -> int:
    """The seed of a fit's input-jitter generator: the program's
    Engine.init_state(seed) (and BatchEngine's fit i) draws it from seed + 1."""
    return seed_of_fit + 1


@dataclasses.dataclass
class Inputs:
    weights: dict[str, torch.Tensor]  # each (fits, *shape), f32
    z: torch.Tensor                   # (fits, 1, H, W, depth)
    aux: object                       # the loss's target: a tensor or dict, (fits, 1, H, W, 3) each
    fit_seeds: list[int]


def make(cfg: dict, fits: int, seed: int, device: torch.device) -> Inputs:
    """A cell's inputs for `fits` fits, in a few large draws from one
    generator on `device` seeded with `seed` (the mask is drawn on the host)."""
    img = cfg["image"]
    h, w = img["height"], img["width"]
    gen = torch.Generator(device=device).manual_seed(seed)
    plist = reference_net(cfg).param_list(cfg["net"], h, w)
    drawn = [p for p in plist if p.bound > 0]
    total = sum(math.prod(p.shape) for p in drawn)
    u = torch.rand((fits, total), generator=gen, device=device)
    weights, off = {}, 0
    for p in plist:
        if p.bound > 0:
            n = math.prod(p.shape)
            weights[p.name] = ((u[:, off:off + n] * 2 - 1) * p.bound).reshape(fits, *p.shape)
            off += n
        else:
            weights[p.name] = torch.full((fits, *p.shape), p.fill, device=device)
    inp = cfg["input"]
    if inp["method"] != "noise":
        raise NotImplementedError(f"input method {inp['method']!r}")
    z = torch.rand((fits, 1, h, w, inp["depth"]), generator=gen, device=device) * inp["var"]
    aux = tasks.load(cfg["task"]).images(img, fits, seed, gen, device)
    return Inputs(weights, z, aux, [fit_seed(seed, i) for i in range(fits)])


def smooth_image(img: dict, fits: int, gen: torch.Generator, device) -> torch.Tensor:
    """(fits, 1, H, W, C) in [0, 1]: per channel two waves of random
    direction, frequency (1 to 6 cycles across) and phase, and a finer one."""
    h, w, c = img["height"], img["width"], img["channels"]
    yy = torch.linspace(0, 1, h, device=device).view(1, h, 1, 1)
    xx = torch.linspace(0, 1, w, device=device).view(1, 1, w, 1)
    r = torch.rand((fits, 3, 4, c), generator=gen, device=device)
    out = torch.full((fits, h, w, c), 0.5, device=device)
    for k, (amp, lo, hi) in enumerate(((0.25, 1, 6), (0.15, 1, 6), (0.05, 12, 40))):
        fy, fx = (lo + (hi - lo) * r[:, k, 0]), (lo + (hi - lo) * r[:, k, 1])
        phase = 2 * math.pi * r[:, k, 2]
        arg = 2 * math.pi * (fy.view(fits, 1, 1, c) * yy + fx.view(fits, 1, 1, c) * xx)
        out += amp * torch.sin(arg + phase.view(fits, 1, 1, c))
    return out.clamp(0, 1).unsqueeze(1)


def fit_slice(x, i: int):
    """Fit i's part of a stacked input (a tensor or a dict of them)."""
    if isinstance(x, dict):
        return {k: v[i] for k, v in x.items()}
    return x[i]
