"""Row blocks: one NHWC tensor cut along H, block k on its own device (the
port's counterpart of an activation that the JAX package pins to
P(None, 'sp', None, None); parallel/spatial.py's SpatialEngine).

The model's own forwards take a `Rows` wherever they take a tensor, so a
sharded fit runs the one definition of every net it can shard:

  - per-pixel work (arithmetic with a per-channel tensor, the activations
    `relu`, `leaky_relu` and `sigmoid` below, a crop along W, a channel
    concat `cat_channels`, the pools on blocks whose heights the stride
    divides) runs on each block, the tensor moved to the block's device;
  - a sum over H and W (BatchNorm's moments over N, H, W; InstanceNorm's
    over H, W) is each block's sum, added in block order on block 0's
    device: the all-reduce, after which every block normalises with the
    same mean and variance;
  - each op that reads across a block's edge (a padded conv's window, the
    bilinear upsample, the fused seam's edge-padded LR input and its
    reflection corrections, the bilinear up2 moments' neighbour products)
    takes a branch for Rows beside its plain form, in its own module, and
    reads the rows past the block's edge through `gather_rows`: from the
    block that owns them (a halo, whose gradient flows back to its owner
    through `.to()` and `torch.cat`), or as the op pads the image past its
    true top and bottom. The transposed conv's and the Lanczos
    downsample's branches are such ops too;
  - a value drawn for the whole image (the texture net's noise) is drawn
    once, as the unsharded op draws it, and cut into the blocks' rows by
    `cut_rows`.

Blocks may differ in height (a transposed conv that adds rows gives them
to the last block). An op with no such branch raises on a Rows (it is not
a tensor) rather than computing a block's result without its neighbours;
Rows has no catch-all that would run an op block by block.
"""

from __future__ import annotations

import functools
import operator
from typing import Callable, Sequence

import torch
import torch.nn.functional as F


class Rows:
    """One NHWC tensor as its row blocks, in order; block k covers image
    rows [starts[k], starts[k] + h_k) and may lie on its own device."""

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = list(blocks)
        self.starts = [0]
        for b in self.blocks[:-1]:
            self.starts.append(self.starts[-1] + b.shape[1])

    @property
    def shape(self) -> tuple[int, int, int, int]:
        n, _, w, c = self.blocks[0].shape
        return (n, self.starts[-1] + self.blocks[-1].shape[1], w, c)

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def heights(self) -> list[int]:
        return [b.shape[1] for b in self.blocks]

    @property
    def devices(self) -> list[torch.device]:
        return [b.device for b in self.blocks]

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Rows":
        return Rows([fn(b) for b in self.blocks])

    def _with(self, op, other) -> "Rows":
        if isinstance(other, Rows):
            return Rows([op(a, b) for a, b in zip(self.blocks, other.blocks)])
        return self.map(lambda b: op(b, other.to(b.device)))

    def __add__(self, other) -> "Rows":
        return self._with(operator.add, other)

    def __sub__(self, other) -> "Rows":
        return self._with(operator.sub, other)

    def __mul__(self, other) -> "Rows":
        return self._with(operator.mul, other)

    def to(self, dtype: torch.dtype) -> "Rows":
        return self.map(lambda b: b.to(dtype))

    def sigmoid(self) -> "Rows":
        return self.map(torch.sigmoid)

    def sum(self, dims: tuple[int, ...]) -> torch.Tensor:
        """The sum over `dims`, which include H: each block's sum, the
        blocks' sums added on block 0's device in block order."""
        if 1 not in dims:
            raise ValueError(f"a sum over {dims} leaves the row axis cut into blocks")
        return allsum([b.sum(dims) for b in self.blocks], self.blocks[0].device)

    def __getitem__(self, idx) -> "Rows":
        """A crop along W (and C): `rows[:, 0:H, a:b, :]`; the row axis is
        not cut."""
        _, rows, *rest = idx
        if rows.indices(self.shape[1]) != (0, self.shape[1], 1):
            raise ValueError("row blocks cannot be cropped along H")
        return self.map(lambda b: b[(slice(None), slice(None), *rest)])

    def gather(self, device: torch.device) -> torch.Tensor:
        """The whole tensor on `device`."""
        return torch.cat([b.to(device) for b in self.blocks], dim=1)


def cut_rows(x: torch.Tensor, devices: Sequence[torch.device],
             heights: Sequence[int] | None = None) -> Rows:
    """x (N, H, W, C) as row blocks, block k on devices[k]: len(devices)
    equal blocks, or blocks of `heights` rows (which sum to H)."""
    n = len(devices)
    if heights is None:
        if x.shape[1] % n:
            raise ValueError(f"image height {x.shape[1]} must divide by mesh size {n}")
        heights = [x.shape[1] // n] * n
    if len(heights) != n or sum(heights) != x.shape[1]:
        raise ValueError(f"row blocks of {list(heights)} rows do not cut {x.shape[1]} rows "
                         f"over {n} devices")
    blocks, start = [], 0
    for h, d in zip(heights, devices):
        blocks.append(x[:, start:start + h].to(d))
        start += h
    return Rows(blocks)


def cat_channels(parts: Sequence[torch.Tensor | Rows]):
    """The channel concat of tensors, or of row blocks of the same rows."""
    if isinstance(parts[0], Rows):
        return Rows([torch.cat(bs, dim=-1) for bs in zip(*(p.blocks for p in parts))])
    return torch.cat(list(parts), dim=-1)


def relu(x: torch.Tensor | Rows):
    """F.relu of a tensor, or of each row block."""
    return x.map(F.relu) if isinstance(x, Rows) else F.relu(x)


def leaky_relu(x: torch.Tensor | Rows, slope: float):
    """F.leaky_relu of a tensor, or of each row block."""
    if isinstance(x, Rows):
        return x.map(lambda b: F.leaky_relu(b, slope))
    return F.leaky_relu(x, slope)


def sigmoid(x: torch.Tensor | Rows):
    """torch.sigmoid of a tensor, or of each row block."""
    return x.sigmoid() if isinstance(x, Rows) else torch.sigmoid(x)


def allsum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The blocks' partial sums added on `device`, in block order."""
    return functools.reduce(operator.add, [p.to(device) for p in parts])


def _source(g: int, height: int, mode: str) -> int | None:
    """The image row that padded row g copies under `mode` (F.pad's names:
    'constant', 'reflect', 'replicate'); None for a zero row."""
    if 0 <= g < height:
        return g
    if mode == "constant":
        return None
    if mode == "reflect":
        return -g if g < 0 else 2 * (height - 1) - g
    return min(max(g, 0), height - 1)


def gather_rows(x: Rows, k: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Image rows [lo, hi) as one tensor on block k's device: block k's own
    rows, and each row outside it from the block that owns it (a halo) or,
    past the image's top and bottom, as `mode` pads it (zero rows,
    reflection or replication of the image's edge rows, whichever block
    holds them). The halo's gradient flows back to its owner."""
    blk = x.blocks[k]
    dev, height = blk.device, x.shape[1]
    start, stop = x.starts[k], x.starts[k] + blk.shape[1]

    def row(g: int) -> torch.Tensor:
        src = _source(g, height, mode)
        if src is None:
            return torch.zeros_like(blk[:, :1])
        j = next(i for i in reversed(range(len(x.starts))) if x.starts[i] <= src)
        return x.blocks[j][:, src - x.starts[j]:src - x.starts[j] + 1].to(dev)

    own_lo, own_hi = max(lo, start), min(hi, stop)
    pieces = [row(g) for g in range(lo, min(hi, start))]
    if own_lo < own_hi:
        pieces.append(blk[:, own_lo - start:own_hi - start])
    pieces += [row(g) for g in range(max(lo, stop), hi)]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


def halo_blocks(x: Rows, above: int, below: int, mode: str) -> list[torch.Tensor]:
    """Each block with `above` rows before it and `below` after it, read as
    gather_rows reads them."""
    return [gather_rows(x, k, x.starts[k] - above, x.starts[k] + b.shape[1] + below, mode)
            for k, b in enumerate(x.blocks)]
