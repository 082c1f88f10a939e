"""Helpers: the network input, image I/O, the inpainting masks and image
grids."""
