"""Many fits at once (counterpart of dip_tpu/parallel): BatchEngine runs B
fits of one shape as one vmapped program per device of a mesh; FitQueue
round-robins separate fits on one device. One fit with its activations
cut into row blocks over a mesh is parallel/spatial.py's SpatialEngine
(imported from there, as the JAX package's is)."""

from dip_tpu_torch.parallel.batch import BatchEngine
from dip_tpu_torch.parallel.mesh import make_mesh, shard_batch
from dip_tpu_torch.parallel.queue import FitQueue

__all__ = ["make_mesh", "shard_batch", "BatchEngine", "FitQueue"]
