"""Plain reference of a DIP fit's first steps: input jitter, the net's
forward, the loss, its gradients, Adam and the output EMA, in float32.

One step of a fit of parameters p to `aux` from input z:

  z_used = z + std * N(0, 1)               (drawn from the fit's jitter generator)
  out    = net(p, z_used);   loss = loss_fn(out, aux);   g = d loss / d p
  Adam   (PyTorch's defaults, betas 0.9 / 0.999, eps 1e-8, bias-corrected)
  ema    = out at the first step, then ema * w + out * (1 - w)   (w None: ema = out)

The reference is given the benchmark's weights, inputs and the seed of
each fit's jitter stream, never anything the program made.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

BETAS, EPS = (0.9, 0.999), 1e-8


def first_steps(forward: Callable, loss_fn: Callable, params0: dict[str, torch.Tensor],
                z: torch.Tensor, aux, fit: dict, jitter: torch.Generator, steps: int,
                update: bool = True) -> dict:
    """`steps` steps of one fit from params0 (left untouched). Returns the
    loss of each step, the first step's gradient of each leaf and its
    output, the leaves after the last step and the output EMA after it.
    `update=False` plants the fault of a step that leaves the parameters as
    they were."""
    params = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    std, lr, w = fit["reg_noise_std"], fit["lr"], fit["exp_weight"]
    losses, grad1, out1, ema = [], None, None, None
    for t in range(1, steps + 1):
        zj = z + std * torch.randn(z.shape, generator=jitter, device=z.device, dtype=z.dtype)
        out = forward(params, zj)
        loss = loss_fn(out, aux)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in zip(params, grads)}
        out = out.detach()
        ema = out if (w is None or ema is None) else ema * w + out * (1 - w)
        out1 = ema if out1 is None else out1
        if not update:
            continue
        with torch.no_grad():
            bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
            for (k, p), g in zip(params.items(), grads):
                m[k].lerp_(g, 1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (v2[k].sqrt() / math.sqrt(bc2)).add_(EPS)
                p.addcdiv_(m[k], denom, value=-lr / bc1)
    return {"losses": losses, "grad1": grad1,
            "params": {k: p.detach() for k, p in params.items()}, "out1": out1, "out": ema}
