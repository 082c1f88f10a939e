"""dip_tpu_torch: the Deep Image Prior framework on PyTorch and CUDA for
one NVIDIA H100, a port of the JAX package dip_tpu (which stays the
reference). Public functions keep dip_tpu's NHWC layout. Imports torch,
never jax."""
