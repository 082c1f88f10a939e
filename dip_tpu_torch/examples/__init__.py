"""The user-facing example scripts of the port (counterparts of the JAX
package's examples/*.py), each runnable as
`python -m dip_tpu_torch.examples.<name> ...`: the same flags and defaults
plus `--device` ('cuda' by default, 'cpu' to run on the CPU). Each has
`main(argv=None)`, which returns 0."""
