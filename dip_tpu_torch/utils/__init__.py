"""Helpers: the network input and image I/O."""
