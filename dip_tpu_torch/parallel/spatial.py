"""Spatial sharding: ONE fit with its activations cut along H into row
blocks, one block per entry of a 1-D 'sp' mesh (counterpart of
dip_tpu/parallel/spatial.py).

The JAX package pins z, the target and the output to P(None, 'sp', None,
None) and lets XLA's SPMD partitioner insert the convolutions' halo
exchanges and BatchNorm's all-reduce. PyTorch has no such partitioner, so
the port writes both, over a row-blocked value (ops/rows.Rows, block k on
mesh device k) that every net's own forward takes in place of a tensor:

  - halo rows: every op that reads across a block's edge (a conv's window,
    a transposed conv's, the bilinear upsample, the Lanczos post-down (K7
    on each block with its halo, at row pad 0), the fused seam's
    edge-padded LR input, the bilinear up2 moments' neighbour products)
    takes the rows it needs from the neighbouring blocks, whose gradient
    flows back to the block that owns them; the image's true top and
    bottom keep the op's own padding (zero, reflection, replication) and
    the seam's reflection corrections;
  - the norms' all-reduce: train-mode BN's f32 sums, InstanceNorm's and
    the up2 moments' sums are taken per block and added on block 0's
    device, and the mean and variance formed once; every block then
    normalises with them;
  - noise drawn for the whole image (TextureNet's fill_noise) is drawn as
    the unsharded net draws it and cut into the blocks' rows;
  - the gradient all-reduce: each parameter reaches a block's device by
    `.to(device)`, so autograd sums the blocks' gradients.

`SpatialEngine` is `fit/engine.Engine` with `_forward` sharded: z (the
jitter drawn for the whole z, so a sharded fit sees the draws of the
unsharded one with its seed) is cut into blocks, the net's forward runs
over them on the fit's parameters, and the output's blocks are gathered
back onto the engine's device, mesh.devices[0]. Every net that
models.get_net builds ('skip' with every downsample_mode, 'UNet',
'ResNet', 'texture_nets', 'identity') and DCGAN take row blocks. The loss,
metrics, EMA, optimizer, backtracking and checkpointing are Engine's.
Where every block sits on one CUDA device (the card's `Mesh([cuda:0] *
n)`), the step is captured and replayed as Engine does; over distinct
devices the steps run eagerly. The seam kernels K1-K4 run once a block at
every fused seam, the weight-gradient kernels K5/K6 once a block at each
routed conv, the downsample kernel K7 once a block at each Lanczos
post-down.

Row rules (`check_input`; W is not sharded), so that each block's pools
and stride-2 ladder start on a row that their stride divides: H /
mesh.size a multiple of 2^scales for a Skip (as the JAX docstring says),
of 2^(4 + more_layers) for a UNet, of max(ratios) for a TextureNet; at
least one row a block for ResNet, DCGAN (whose stem's 2 extra rows go to
the last block) and the identity net. Refused, with the reason: a height
outside its net's rule, any other module, and a fused seam over a block
of one LR row (the seam kernels need h >= 2: fewer blocks or a taller
image).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from dip_tpu_torch.fit.engine import Engine, FitConfig, FitState, resolve_device
from dip_tpu_torch.models import DCGAN, Identity, ResNet, Skip, TextureNet, UNet
from dip_tpu_torch.ops.rows import cut_rows
from dip_tpu_torch.parallel.mesh import Mesh, make_mesh

NETS = (Skip, UNet, ResNet, TextureNet, DCGAN, Identity)


def check_spatial(model: nn.Module) -> None:
    """Raise for a module that SpatialEngine cannot shard: one that is not
    a net of the zoo."""
    if not isinstance(model, NETS):
        raise ValueError(f"SpatialEngine shards the zoo's nets "
                         f"({', '.join(n.__name__ for n in NETS)}), not "
                         f"{type(model).__name__}: its ops may not take row blocks")


def row_multiple(model: nn.Module) -> tuple[int, str]:
    """What each block's height must be a multiple of for `model`, and why."""
    if isinstance(model, Skip):
        return 2 ** len(model.ch_skip), f"2^scales = {2 ** len(model.ch_skip)}"
    if isinstance(model, UNet):
        k = 4 + model.more_layers
        return 2 ** k, f"2^(4 + more_layers) = {2 ** k} (its max-pools)"
    if isinstance(model, TextureNet):
        return max(model.ratios), f"max(ratios) = {max(model.ratios)} (its avg-pools)"
    return 1, "1"


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
        model: a net of the zoo (check_spatial); z is (1, H, W, C) with H /
            mesh.size a multiple of the net's row rule (check_input).
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
        """Raise unless z's rows cut into mesh.size equal blocks whose
        height is a multiple of the net's row rule (row_multiple): each
        block's pools and stride-2 ladder start on rows that their stride
        divides at every scale."""
        n = self.mesh.size
        if z.dim() != 4 or z.shape[1] % n or z.shape[1] < n:
            raise ValueError(f"image height {z.shape[1]} must divide by mesh size {n}")
        k, why = row_multiple(self.model)
        if (z.shape[1] // n) % k:
            raise ValueError(f"a row block of {z.shape[1] // n} rows: H / mesh size must be a "
                             f"multiple of {why} for {type(self.model).__name__}")

    def init_state(self, seed: int, z: torch.Tensor,
                   extra_params: dict[str, torch.Tensor] | None = None) -> FitState:
        self.check_input(z)
        return super().init_state(seed, z, extra_params)

    def _forward(self, net: dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
        """Engine's forward on z cut into row blocks, the output's blocks
        gathered onto the engine's device."""
        return super()._forward(net, cut_rows(z, self.blocks)).gather(self.device)
