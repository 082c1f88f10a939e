"""Tensor ops of the port; the ops/hopper_*.py modules hold the Hopper
kernels' wrappers and plain versions (sources in csrc/)."""
