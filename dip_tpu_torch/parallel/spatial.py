"""Spatial sharding: ONE fit with its activations cut along H into row
blocks, one block per entry of a 1-D 'sp' mesh (counterpart of
dip_tpu/parallel/spatial.py).

The JAX package pins z, the target and the output to P(None, 'sp', None,
None) and lets XLA's SPMD partitioner insert the convolutions' halo
exchanges and BatchNorm's all-reduce. PyTorch has no such partitioner, so
the port writes both, over a row-blocked value (ops/rows.Rows, block k on
mesh device k) that the Skip's own forward takes in place of a tensor:

  - halo rows: every op that reads across a block's edge (a conv's window,
    the bilinear upsample, the fused seam's edge-padded LR input, the
    bilinear up2 moments' neighbour products) takes the rows it needs from
    the neighbouring blocks, whose gradient flows back to the block that
    owns them; the image's true top and bottom keep the op's own padding
    (zero, reflection, replication) and the seam's reflection corrections;
  - the BN all-reduce: train-mode BN's f32 sums and the up2 moments' sums
    are taken per block and added on block 0's device, and the mean and
    variance formed once; every block then normalises with them;
  - the gradient all-reduce: each parameter reaches a block's device by
    `.to(device)`, so autograd sums the blocks' gradients.

`SpatialEngine` is `fit/engine.Engine` with `_forward` sharded: z (the
jitter drawn for the whole z, so a sharded fit sees the draws of the
unsharded one with its seed) is cut into blocks, Skip.forward runs over
them on the fit's parameters, and the 3-channel output's blocks are
gathered back onto the engine's device, mesh.devices[0]. The loss,
metrics, EMA, optimizer, backtracking and checkpointing are Engine's.
Where every block sits on one CUDA device (the card's `Mesh([cuda:0] *
n)`), the step is captured and replayed as Engine does; over distinct
devices the steps run eagerly. The seam kernels K1-K4 run once a block at
every fused seam, the weight-gradient kernels once a block at each routed
conv.

Practical notes (as the JAX docstring's): H / mesh.size must be a multiple
of 2^scales, so that each block's stride-2 ladder starts on an even row;
W is not sharded. Refused, with the reason: any net but Skip, and a Skip
whose post-down is the Lanczos downsample (K7 pads inside the kernel).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from dip_tpu_torch.fit.engine import Engine, FitConfig, FitState, resolve_device
from dip_tpu_torch.models.skip import Skip
from dip_tpu_torch.ops.rows import cut_rows
from dip_tpu_torch.parallel.mesh import Mesh, make_mesh


def check_spatial(model: nn.Module) -> None:
    """Raise for what SpatialEngine cannot shard: nets other than Skip, and
    a Skip with the Lanczos post-down."""
    if not isinstance(model, Skip):
        raise ValueError(f"SpatialEngine shards a Skip only, not {type(model).__name__}: "
                         f"the ops of no other net take row blocks")
    for conv in model.convs:
        if conv.post_down not in (None, "avg", "max"):
            raise ValueError(f"SpatialEngine cannot shard the {conv.post_down!r} post-down: "
                             f"the downsample kernel (K7) replication-pads its input inside "
                             f"the kernel, with no halo rows from the neighbouring blocks")


def make_spatial_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D 'sp' mesh over the first `n_devices` CUDA devices (all by
    default); raises without one. `Mesh([device] * n, axis='sp')` repeats
    one device (n blocks on one card, or on the CPU)."""
    return make_mesh(n_devices, axis="sp")


class SpatialEngine(Engine):
    """Engine for ONE fit with H-sharded activations over `mesh` (see the
    module docstring). The API is Engine's: init_state(seed, z,
    extra_params), step, run, run_chunk, render.

    Args:
        model: a Skip (check_spatial); z is (1, H, W, C) with H / mesh.size
            a multiple of 2^scales.
        loss_fn, cfg, metrics_fn: as Engine's; they see the whole output,
            gathered onto the engine's device.
        mesh: a parallel.mesh.Mesh, block k on mesh.devices[k]; default
            make_spatial_mesh(). The params, optimizer and loss sit on
            mesh.devices[0].
    """

    def __init__(self, model: nn.Module, loss_fn: Callable, cfg: FitConfig,
                 metrics_fn: Callable | None = None, mesh: Mesh | None = None):
        check_spatial(model)
        mesh = mesh or make_spatial_mesh()
        super().__init__(model, loss_fn, cfg, metrics_fn, device=mesh.devices[0])
        self.mesh = mesh
        self.blocks = tuple(resolve_device(d) for d in mesh.devices)
        if len(set(self.blocks)) > 1:
            self._stream = None  # eager steps over distinct devices

    def check_input(self, z: torch.Tensor) -> None:
        """Raise unless z's rows cut into mesh.size blocks whose stride-2
        ladder starts on even rows at every scale."""
        n, scales = self.mesh.size, len(self.model.ch_skip)
        if z.dim() != 4 or z.shape[1] % n:
            raise ValueError(f"image height {z.shape[1]} must divide by mesh size {n}")
        if (z.shape[1] // n) % 2 ** scales:
            raise ValueError(f"a row block of {z.shape[1] // n} rows: H / mesh size must be a "
                             f"multiple of 2^scales = {2 ** scales}")

    def init_state(self, seed: int, z: torch.Tensor,
                   extra_params: dict[str, torch.Tensor] | None = None) -> FitState:
        self.check_input(z)
        return super().init_state(seed, z, extra_params)

    def _forward(self, net: dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
        """Engine's forward on z cut into row blocks, the output's blocks
        gathered onto the engine's device."""
        return super()._forward(net, cut_rows(z, self.blocks)).gather(self.device)
