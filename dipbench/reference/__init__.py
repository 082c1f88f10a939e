"""The benchmark's plain references: plain PyTorch in float32 with TF32 off,
importing nothing of the program (`dip_tpu_torch`) nor of the JAX package.
A configuration names its reference module by its `reference` key."""
