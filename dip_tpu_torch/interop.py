"""Weights across packages: flax `Skip` params <-> the port's state_dict,
and a fit's whole trainable set.

Flax numbers its submodules by type in creation order: `Conv_{i}/Conv_0/
{kernel,bias}` and `TrainBatchNorm_{i}/{scale,bias}`. The port's Skip
creates its convs and BNs in the same order, so `Conv_{i}` is `convs.{i}`
and `TrainBatchNorm_{i}` is `bns.{i}`. Kernels go from HWIO to OIHW.
Leaves on the flax side are numpy arrays (convert jax arrays with
np.asarray first); this module imports neither jax nor flax.

A fit's trainable set is `{'net': <flax params>, 'input': z, 'down':
{'kernel': K x K}}` in the JAX engine (each key but 'net' optional) and
one flat dict in the port's (fit/engine.py): the net's state_dict keys
plus 'input' and 'down' as tensors.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_FLAX_KEY = re.compile(r"(Conv|TrainBatchNorm)_(\d+)$")
_PORT_KEY = re.compile(r"(convs|bns)\.(\d+)\.(weight|bias)$")


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        m = _FLAX_KEY.match(name)
        if m is None:
            raise KeyError(f"unexpected flax module {name!r}")
        i = int(m.group(2))
        if m.group(1) == "Conv":
            leaf = sub["Conv_0"]
            kernel = np.asarray(leaf["kernel"], dtype=np.float32)
            sd[f"convs.{i}.weight"] = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
            if "bias" in leaf:
                sd[f"convs.{i}.bias"] = torch.from_numpy(
                    np.asarray(leaf["bias"], dtype=np.float32).copy())
        else:
            sd[f"bns.{i}.weight"] = torch.from_numpy(
                np.asarray(sub["scale"], dtype=np.float32).copy())
            sd[f"bns.{i}.bias"] = torch.from_numpy(
                np.asarray(sub["bias"], dtype=np.float32).copy())
    return sd


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> dict:
    """The inverse map, with numpy leaves."""
    params: dict = {}
    for key, t in sd.items():
        m = _PORT_KEY.match(key)
        if m is None:
            raise KeyError(f"unexpected state_dict key {key!r}")
        kind, i, leaf = m.groups()
        a = t.detach().cpu().to(torch.float32).numpy()
        if kind == "convs":
            conv = params.setdefault(f"Conv_{i}", {}).setdefault("Conv_0", {})
            conv["kernel" if leaf == "weight" else "bias"] = (
                a.transpose(2, 3, 1, 0).copy() if leaf == "weight" else a.copy())
        else:
            bn = params.setdefault(f"TrainBatchNorm_{i}", {})
            bn["scale" if leaf == "weight" else "bias"] = a.copy()
    return params


_EXTRA = ("input", "down")


def flax_trainable_to_torch(trainable: Mapping) -> dict[str, torch.Tensor]:
    """The JAX engine's trainable pytree -> the port's flat trainable dict."""
    unknown = set(trainable) - {"net", *_EXTRA}
    if unknown:
        raise KeyError(f"unexpected trainable leaves {sorted(unknown)}")
    out = flax_to_state_dict(trainable.get("net", {}))
    for k in _EXTRA:
        if k in trainable:
            leaf = trainable[k]["kernel"] if k == "down" else trainable[k]
            out[k] = torch.from_numpy(np.asarray(leaf, dtype=np.float32).copy())
    return out


def torch_trainable_to_flax(params: Mapping[str, torch.Tensor]) -> dict:
    """The inverse map, with numpy leaves."""
    out: dict = {"net": state_dict_to_flax(
        {k: v for k, v in params.items() if k not in _EXTRA})}
    for k in _EXTRA:
        if k in params:
            a = params[k].detach().cpu().to(torch.float32).numpy().copy()
            out[k] = {"kernel": a} if k == "down" else a
    return out
