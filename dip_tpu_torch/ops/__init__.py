"""Tensor ops of the port; ops/hopper_up_conv.py holds the Hopper kernels."""
