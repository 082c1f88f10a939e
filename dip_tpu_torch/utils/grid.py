"""Image-grid assembly, plain numpy (counterpart of dip_tpu/utils/grid.py):
the reference's get_image_grid / plot_image_grid on HWC arrays.
matplotlib is imported only by plot_image_grid, which returns the grid
without drawing when it is missing.
"""

from __future__ import annotations

import numpy as np


def get_image_grid(images: list[np.ndarray], nrow: int = 8, pad: int = 2,
                   pad_value: float = 0.0) -> np.ndarray:
    """Tile a list of HWC float images into one HWC f32 grid, `nrow`
    images a row, `pad` pixels of `pad_value` around each. Grayscale (HW1)
    images are repeated to 3 channels when mixed with RGB."""
    if not images:
        raise ValueError("empty image list")
    n_ch = max(im.shape[-1] for im in images)
    if n_ch not in (1, 3):
        raise ValueError("images must have 1 or 3 channels")
    imgs = [im if im.shape[-1] == n_ch else np.repeat(im, n_ch, axis=-1) for im in images]
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)
    ncol = min(nrow, len(imgs))
    nrows = -(-len(imgs) // ncol)
    grid = np.full((pad + nrows * (h + pad), pad + ncol * (w + pad), n_ch), pad_value,
                   dtype=np.float32)
    for idx, im in enumerate(imgs):
        r, c = divmod(idx, ncol)
        y0, x0 = pad + r * (h + pad), pad + c * (w + pad)
        grid[y0:y0 + im.shape[0], x0:x0 + im.shape[1]] = im
    return grid


def plot_image_grid(images: list[np.ndarray], nrow: int = 8, factor: int = 1,
                    interpolation: str = "lanczos") -> np.ndarray:
    """Draw the grid with matplotlib where it is installed; return it."""
    grid = get_image_grid(images, nrow)
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return grid
    plt.figure(figsize=(len(images) + factor, 12 + factor))
    if grid.shape[-1] == 1:
        plt.imshow(grid[..., 0], cmap="gray", interpolation=interpolation)
    else:
        plt.imshow(grid, interpolation=interpolation)
    plt.show()
    return grid
