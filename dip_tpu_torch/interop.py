"""Weights across packages: flax params <-> the port's state_dict, and a
fit's whole trainable set.

Flax numbers the submodules of each module by class, in creation order:
`Conv_{i}/Conv_0/{kernel,bias}`, `ConvTranspose_{i}/ConvTranspose_0/
{kernel,bias}`, `TrainBatchNorm_{i}/{scale,bias}`, and nested modules
such as UNet's `_DoubleConv_{i}/...`. Every port model registers its
submodules of each class in the flax module's creation order, so
`flax_paths` walks the port model and names each parameter-holding
submodule's flax path by class and index (module lists are transparent);
the leaves are then looked up by path, never by the order of a dict
(flax's keys sort as strings: `Conv_10` before `Conv_2`). Conv kernels go
from HWIO to OIHW; a transposed conv's HWIO kernel, which flax applies
unflipped, goes to (in, out, kh, kw) flipped in both spatial axes, the
orientation of torch's conv_transpose2d.

The frozen backbones (pretrained/backbones.py) name their layers as the
flax modules do, `conv1_1` ... `fc8`, each flax layer holding {'kernel',
'bias'} itself: conv kernels go from HWIO (grouped: (kh, kw, Cin/groups,
Cout)) to OIHW, Dense kernels from (in, out) to (out, in).

Without a model the functions take the skip net's flat layout, `Conv_{i}`
<-> `convs.{i}` and `TrainBatchNorm_{i}` <-> `bns.{i}`, which is what
flax_paths gives for a Skip. It stays for the callers that hold a skip
net's weights and no model (a flax tree or a state_dict alone): with no
module to walk, `_skip_layout` reads each module's kind and index from
its name. Leaves on the flax side are numpy arrays
(convert jax arrays with np.asarray first); this module imports neither
jax nor flax.

A fit's trainable set is `{'net': <flax params>, 'input': z, 'down':
{'kernel': K x K}}` in the JAX engine (each key but 'net' optional) and
one flat dict in the port's (fit/engine.py): the net's state_dict keys
plus 'input' and 'down' as tensors.
"""

from __future__ import annotations

import re
from typing import Iterator, Mapping

import numpy as np
import torch
import torch.nn as nn

from dip_tpu_torch.models.blocks import Conv, ConvTranspose, TrainBatchNorm
from dip_tpu_torch.pretrained.backbones import Backbone, BackboneConv, BackboneDense

_FLAX_KEY = re.compile(r"(Conv|TrainBatchNorm)_(\d+)$")
_PORT_KEY = re.compile(r"(convs|bns)\.(\d+)\.(weight|bias)$")


_LEAVES = (Conv, ConvTranspose, TrainBatchNorm)


def _children(mod: nn.Module, prefix: str) -> Iterator[tuple[str, nn.Module]]:
    """mod's submodules with their state_dict prefixes, module lists
    flattened into their items."""
    for name, child in mod.named_children():
        if isinstance(child, nn.ModuleList):
            yield from _children(child, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", child


def flax_paths(model: nn.Module) -> dict[str, tuple[tuple[str, ...], nn.Module]]:
    """state_dict prefix -> (flax path, module) of every Conv,
    ConvTranspose and TrainBatchNorm of `model`."""
    out: dict = {}

    def walk(mod, prefix, path):
        seen: dict[str, int] = {}
        for name, child in _children(mod, prefix):
            kind = type(child).__name__
            seen[kind] = seen.get(kind, 0) + 1
            child_path = (*path, f"{kind}_{seen[kind] - 1}")
            if isinstance(child, _LEAVES):
                out[name] = (child_path, child)
            else:
                walk(child, f"{name}.", child_path)

    walk(model, "", ())
    return out


def _np(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    """A tensor of its own (a contiguous copy of a)."""
    return torch.from_numpy(np.array(a, order="C"))


def _flax_leaves(kind: type, sub: Mapping) -> dict[str, torch.Tensor]:
    """One flax module's params -> the parameters of the port module of
    class `kind`, by name."""
    if kind is TrainBatchNorm:
        return {"weight": _t(_np(sub["scale"])), "bias": _t(_np(sub["bias"]))}
    if kind is BackboneDense:
        return {"weight": _t(_np(sub["kernel"]).T), "bias": _t(_np(sub["bias"]))}
    leaf = sub if kind is BackboneConv else sub[kind.__name__ + "_0"]
    kernel = _np(leaf["kernel"])
    if kind is ConvTranspose:
        kernel = kernel[::-1, ::-1].transpose(2, 3, 0, 1)
    else:
        kernel = kernel.transpose(3, 2, 0, 1)
    out = {"weight": _t(kernel)}
    if "bias" in leaf:
        out["bias"] = _t(_np(leaf["bias"]))
    return out


def _port_leaves(kind: type, tensors: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of _flax_leaves, with numpy leaves."""
    a = {k: t.detach().cpu().to(torch.float32).numpy() for k, t in tensors.items()}
    if kind is TrainBatchNorm:
        return {"scale": a["weight"].copy(), "bias": a["bias"].copy()}
    if kind is BackboneDense:
        return {"kernel": np.array(a["weight"].T, order="C"), "bias": a["bias"].copy()}
    w = a["weight"]
    kernel = (w.transpose(2, 3, 0, 1)[::-1, ::-1] if kind is ConvTranspose
              else w.transpose(2, 3, 1, 0))
    leaf = {"kernel": np.array(kernel, order="C")}
    if "bias" in a:
        leaf["bias"] = a["bias"].copy()
    return leaf if kind is BackboneConv else {kind.__name__ + "_0": leaf}


def _layout(model: nn.Module) -> dict[str, tuple[tuple[str, ...], type]]:
    """state_dict prefix -> (flax path, class) of each parameter-holding
    module of `model` (a backbone's layers by their own names)."""
    if isinstance(model, Backbone):
        return {name: ((name,), type(m)) for name, m in model.named_children()
                if isinstance(m, (BackboneConv, BackboneDense))}
    return {prefix: (path, type(m)) for prefix, (path, m) in flax_paths(model).items()}


def _skip_layout(names, pattern: re.Pattern) -> dict[str, tuple[tuple[str, ...], type]]:
    """The skip net's flat layout over flax module names or state_dict keys
    (`pattern` parses either into its kind and index)."""
    layout = {}
    for name in names:
        m = pattern.match(name)
        if m is None:
            raise KeyError(f"unexpected name {name!r}")
        kind, i = m.group(1), m.group(2)
        conv = kind in ("Conv", "convs")
        layout[f"{'convs' if conv else 'bns'}.{i}"] = (
            (f"{'Conv' if conv else 'TrainBatchNorm'}_{i}",), Conv if conv else TrainBatchNorm)
    return layout


def _count(tree: Mapping) -> int:
    return sum(_count(v) if isinstance(v, Mapping) else 1 for v in tree.values())


def flax_to_state_dict(params: Mapping, model: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """flax params -> the state_dict of `model` (of a Skip without one).
    Raises KeyError where a flax leaf has no place in the model."""
    layout = _skip_layout(params, _FLAX_KEY) if model is None else _layout(model)
    sd: dict[str, torch.Tensor] = {}
    for prefix, (path, kind) in layout.items():
        sub = params
        for name in path:
            sub = sub[name]
        sd.update({f"{prefix}.{k}": v for k, v in _flax_leaves(kind, sub).items()})
    if len(sd) != _count(params):
        raise KeyError(f"the flax tree has {_count(params)} leaves, the model takes {len(sd)}")
    return sd


def state_dict_to_flax(sd: Mapping[str, torch.Tensor], model: nn.Module | None = None) -> dict:
    """The inverse map, with numpy leaves."""
    layout = _skip_layout(sd, _PORT_KEY) if model is None else _layout(model)
    params: dict = {}
    used = 0
    for prefix, (path, kind) in layout.items():
        tensors = {k: sd[f"{prefix}.{k}"] for k in ("weight", "bias") if f"{prefix}.{k}" in sd}
        used += len(tensors)
        sub = params
        for name in path:
            sub = sub.setdefault(name, {})
        sub.update(_port_leaves(kind, tensors))
    if used != len(sd):
        raise KeyError(f"the state_dict has {len(sd)} tensors, the model takes {used}")
    return params


_EXTRA = ("input", "down")


def flax_trainable_to_torch(trainable: Mapping,
                            model: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """The JAX engine's trainable pytree -> the port's flat trainable dict
    (the net's leaves mapped as flax_to_state_dict maps them)."""
    unknown = set(trainable) - {"net", *_EXTRA}
    if unknown:
        raise KeyError(f"unexpected trainable leaves {sorted(unknown)}")
    out = flax_to_state_dict(trainable.get("net", {}), model)
    for k in _EXTRA:
        if k in trainable:
            leaf = trainable[k]["kernel"] if k == "down" else trainable[k]
            out[k] = torch.from_numpy(np.asarray(leaf, dtype=np.float32).copy())
    return out


def torch_trainable_to_flax(params: Mapping[str, torch.Tensor],
                            model: nn.Module | None = None) -> dict:
    """The inverse map, with numpy leaves."""
    out: dict = {"net": state_dict_to_flax(
        {k: v for k, v in params.items() if k not in _EXTRA}, model)}
    for k in _EXTRA:
        if k in params:
            a = params[k].detach().cpu().to(torch.float32).numpy().copy()
            out[k] = {"kernel": a} if k == "down" else a
    return out


def _fit_slice(tree: Mapping, i: int) -> dict:
    """Fit i of a batched numpy tree (every leaf with a leading fit axis)."""
    return {k: _fit_slice(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


def _fits_of(tree: Mapping) -> int:
    for v in tree.values():
        return _fits_of(v) if isinstance(v, Mapping) else np.asarray(v).shape[0]
    raise KeyError("an empty tree has no fits")


def flax_batch_to_torch(trainable: Mapping,
                        model: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """A batched JAX trainable pytree (dip_tpu's BatchEngine params: numpy
    leaves with a leading fit axis) -> the port's stacked leaves, each
    (B, ...): flax_trainable_to_torch of each fit's slice, stacked."""
    per_fit = [flax_trainable_to_torch(_fit_slice(trainable, i), model)
               for i in range(_fits_of(trainable))]
    return {k: torch.stack([p[k] for p in per_fit]) for k in per_fit[0]}
