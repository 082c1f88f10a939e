"""Helpers: the network input, image I/O, the inpainting masks and image
grids."""

from dip_tpu_torch.utils.grid import get_image_grid
from dip_tpu_torch.utils.image_io import (chw_to_hwc, crop_image, get_image, hwc_to_chw,
                                          hwc_to_nhwc, load_image, nhwc_to_hwc, np_to_pil,
                                          pil_to_np, save_image)
from dip_tpu_torch.utils.masks import get_bernoulli_mask, get_text_mask
from dip_tpu_torch.utils.noise import get_noise

__all__ = [
    "load_image",
    "save_image",
    "crop_image",
    "get_image",
    "pil_to_np",
    "np_to_pil",
    "hwc_to_nhwc",
    "nhwc_to_hwc",
    "chw_to_hwc",
    "hwc_to_chw",
    "get_noise",
    "get_text_mask",
    "get_bernoulli_mask",
    "get_image_grid",
]
