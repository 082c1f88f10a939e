"""Helpers: the network input."""
