"""dipbench: the benchmark of dip_tpu_torch, the PyTorch and CUDA port of
Deep Image Prior, on one NVIDIA H100. See README.md; the entry is run.py."""
