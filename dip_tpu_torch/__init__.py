"""dip_tpu_torch: the Deep Image Prior framework on PyTorch and CUDA for
one NVIDIA H100, a port of the JAX package dip_tpu (which stays the
reference). Public functions keep dip_tpu's NHWC layout. Imports torch,
never jax."""

from dip_tpu_torch.fit.engine import FitConfig, fit, init_fit
from dip_tpu_torch.models import get_net
from dip_tpu_torch.utils.noise import get_noise

__all__ = [
    "get_net",
    "get_noise",
    "FitConfig",
    "fit",
    "init_fit",
]

__version__ = "0.1.0"
