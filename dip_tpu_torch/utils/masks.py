"""Inpainting and restoration masks (counterpart of dip_tpu/utils/masks.py).

HWC float32 arrays in {0, 1}, sized like the target image. The text mask
draws with Pillow, imported inside `get_text_mask` only, so the package and
every task that is given its mask as an array run without it.
"""

from __future__ import annotations

import os

import numpy as np

_FONT_CANDIDATES = [
    "/usr/share/fonts/truetype/freefont/FreeSansBold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
]


def get_text_mask(shape_hwc: tuple[int, int, int], text: str = "hello world",
                  font_size: int = 20, xy: tuple[int, int] = (128, 128)) -> np.ndarray:
    """A white mask with `text` drawn in black at `xy`, in a bold sans font
    (the first of _FONT_CANDIDATES that exists, else Pillow's default)."""
    from PIL import Image, ImageDraw, ImageFont

    h, w, c = shape_hwc
    path = next((p for p in _FONT_CANDIDATES if os.path.exists(p)), None)
    font = ImageFont.load_default() if path is None else ImageFont.truetype(path, font_size)
    canvas = Image.new("RGB" if c == 3 else "L", (w, h),
                       color=255 if c == 1 else (255, 255, 255))
    ImageDraw.Draw(canvas).text(xy, text, font=font, fill=0 if c == 1 else (0, 0, 0))
    ar = np.array(canvas).astype(np.float32) / 255.0
    if ar.ndim == 2:
        ar = ar[..., None]
    return (ar > 0.5).astype(np.float32)


def get_bernoulli_mask(shape_hwc: tuple[int, int, int], zero_fraction: float = 0.95,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Random keep-mask: each pixel survives with probability 1 - zero_fraction."""
    rng = rng or np.random.default_rng(0)
    return (rng.random(shape_hwc) > zero_fraction).astype(np.float32)
