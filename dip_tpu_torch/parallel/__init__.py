"""Multi-fit scheduling on one device (counterpart of dip_tpu/parallel;
the mesh and the batched engine are not ported yet)."""

from dip_tpu_torch.parallel.queue import FitQueue

__all__ = ["FitQueue"]
