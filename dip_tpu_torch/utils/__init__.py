"""Helpers: the network input, image I/O and the inpainting masks."""
