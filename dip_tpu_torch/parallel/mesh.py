"""Device mesh (counterpart of dip_tpu/parallel/mesh.py).

DIP has no gradient coupling between images, so the scaling axis is
images across devices: a 1-D 'data' mesh, each device fitting its own
contiguous chunk of the batch, and no collective in the hot loop. PyTorch
has no sharded array, so `shard_batch` gives one tree per device: leaf
chunks along the leading axis, each on its device. parallel/batch.py's
BatchEngine runs one sub-batch per device of the mesh.

`make_mesh` covers the visible CUDA devices and raises when there are
none; a `Mesh` also takes an explicit device list (the CPU tests build a
two-entry CPU mesh).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


class Mesh:
    """A 1-D mesh: `devices` in order, one chunk of the batch each."""

    def __init__(self, devices: Sequence[torch.device | str], axis: str = "data"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """A mesh over the first `n_devices` CUDA devices (all by default)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh needs CUDA devices and there are none; build a "
                           "Mesh of explicit devices instead")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 0 < n <= count:
        raise ValueError(f"{n} devices asked for, {count} visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """fn over the leaves of nested dicts, lists and tuples (None stays)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(tree: Any, mesh: Mesh) -> list[Any]:
    """One tree per device of `mesh`: every leaf's leading (batch) axis cut
    into mesh.size contiguous chunks, chunk k on device k; rank-0 leaves
    are replicated. The batch must divide by the mesh size."""
    def chunk(x, k: int) -> torch.Tensor:
        x = torch.as_tensor(x)
        if x.dim() == 0:
            return x.to(mesh.devices[k])
        if x.shape[0] % mesh.size:
            raise ValueError(f"batch {x.shape[0]} must divide by mesh size {mesh.size}")
        per = x.shape[0] // mesh.size
        return x[k * per:(k + 1) * per].to(mesh.devices[k])

    return [tree_map(lambda x, k=k: chunk(x, k), tree) for k in range(mesh.size)]


def replicate(tree: Any, mesh: Mesh) -> list[Any]:
    """One copy of `tree` per device of `mesh`."""
    return [tree_map(lambda x, d=d: torch.as_tensor(x).to(d), tree) for d in mesh.devices]
