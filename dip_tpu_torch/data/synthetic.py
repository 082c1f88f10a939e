"""Reproducible synthetic test images (counterpart of
dip_tpu/data/synthetic.py): a fixed set of deterministic images with
photo-like statistics (smooth shading, edges, texture) for tests, benches
and demos, made with numpy; no binary assets.

The random draws of 'disks' and 'texture' are seeded from a CRC-32 of the
name, so an image is the same in every process. (The JAX package seeds
them from Python's `hash`, which changes per process unless
PYTHONHASHSEED is set; its 'bands', 'checker' and 'gradient' are equal to
these.)
"""

from __future__ import annotations

import zlib

import numpy as np


def synthetic_image(name: str = "bands", size: int = 256,
                    channels: int = 3) -> np.ndarray:
    """HWC float32 in [0,1]. Deterministic per (name, size)."""
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = xx / w, yy / h
    rng = np.random.default_rng(zlib.crc32(name.encode()))

    if name == "bands":
        img = np.stack([
            0.5 + 0.5 * np.sin(2 * np.pi * (3 * u + v)),
            0.5 + 0.5 * np.cos(2 * np.pi * (2 * v)),
            u * v,
        ], axis=-1)
    elif name == "disks":
        img = np.zeros((h, w, 3), np.float32)
        for _ in range(12):
            cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(8, size / 4)
            m = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
            img[m] = rng.uniform(0.1, 0.9, 3)
        img = 0.7 * img + 0.3 * np.stack([u, v, 1 - u], -1)
    elif name == "checker":
        c = (((xx // (size // 16)).astype(int) + (yy // (size // 16)).astype(int)) % 2)
        img = np.stack([c * 0.8 + 0.1, 1 - c * 0.8 - 0.1, np.full_like(u, 0.5)], -1)
    elif name == "texture":
        base = rng.normal(size=(h // 8, w // 8, 3))
        img = np.kron(base, np.ones((8, 8, 1)))
        img = (img - img.min()) / (np.ptp(img) + 1e-9)
    elif name == "gradient":
        img = np.stack([u, v, (u + v) / 2], -1)
    else:
        raise ValueError(f"unknown synthetic image {name!r}")

    img = img.astype(np.float32)
    if channels == 1:
        img = img.mean(-1, keepdims=True).astype(np.float32)
    return np.clip(img, 0, 1)


SYNTHETIC_SET = ["bands", "disks", "checker", "texture", "gradient"]
