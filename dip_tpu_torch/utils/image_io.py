"""Image loading and layout conversion (counterpart of
dip_tpu/utils/image_io.py). Host numpy, float32 in [0, 1], HWC; the fit's
layout is NHWC.

Pillow is imported inside the functions that need it, so the package (and
every path that takes its images as arrays) runs without it.
"""

from __future__ import annotations

import numpy as np


def _pil():
    from PIL import Image

    return Image


def load_image(path: str):
    return _pil().open(path)


def save_image(path: str, img_np: np.ndarray) -> None:
    """Save an HWC (or HW / HW1) float [0,1] array as an image file."""
    np_to_pil(img_np).save(path)


def crop_image(img, d: int = 32):
    """Centre-crop a PIL image so both dims are divisible by `d`."""
    new_w = img.size[0] - img.size[0] % d
    new_h = img.size[1] - img.size[1] % d
    bbox = (
        int((img.size[0] - new_w) / 2),
        int((img.size[1] - new_h) / 2),
        int((img.size[0] + new_w) / 2),
        int((img.size[1] + new_h) / 2),
    )
    return img.crop(bbox)


def get_image(path: str, imsize: int | tuple[int, int] = -1):
    """Load an image and optionally resize it (bicubic up, Lanczos down).
    Returns (PIL image, HWC float array)."""
    image = _pil()
    img = load_image(path)
    if isinstance(imsize, int):
        imsize = (imsize, imsize)
    if imsize[0] != -1 and img.size != imsize:
        img = img.resize(imsize, image.BICUBIC if imsize[0] > img.size[0] else image.LANCZOS)
    return img, pil_to_np(img)


def pil_to_np(img) -> np.ndarray:
    """PIL -> HWC float32 in [0,1] (grayscale -> HW1, alpha dropped)."""
    ar = np.array(img)
    if ar.ndim == 2:
        ar = ar[..., None]
    if ar.shape[-1] == 4:
        ar = ar[..., :3]
    return ar.astype(np.float32) / 255.0


def np_to_pil(img_np: np.ndarray):
    """HWC (or HW / HW1) float [0,1] -> PIL."""
    ar = np.clip(np.asarray(img_np) * 255.0, 0, 255).astype(np.uint8)
    if ar.ndim == 3 and ar.shape[-1] == 1:
        ar = ar[..., 0]
    return _pil().fromarray(ar)


def hwc_to_nhwc(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)[None]


def nhwc_to_hwc(x) -> np.ndarray:
    """First image of an NHWC array or tensor, as numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)[0]
