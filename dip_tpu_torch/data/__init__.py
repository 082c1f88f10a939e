"""Reference data and synthetic images (counterpart of dip_tpu/data)."""

import os

from dip_tpu_torch.data.synthetic import SYNTHETIC_SET, synthetic_image

__all__ = ["synthetic_image", "SYNTHETIC_SET", "reference_data_dir"]


def reference_data_dir(required: bool = True) -> str | None:
    """The reference repo's `data/` directory, from `$DIP_REFERENCE_DATA`.

    The package ships no photos; tools that reproduce the reference read
    its images from the directory the user names there, and nowhere else.
    With required=True (the default) an unset or missing directory raises
    with what to do; required=False returns None, so that callers can use
    the synthetic set (dip_tpu_torch.data.synthetic) instead.
    """
    d = os.environ.get("DIP_REFERENCE_DATA", "")
    if d and os.path.isdir(d):
        return d
    if not required:
        return None
    raise FileNotFoundError(
        f"reference data directory not found: DIP_REFERENCE_DATA={d!r}. Point "
        "DIP_REFERENCE_DATA at a checkout of the reference repo's data/ directory "
        "(deep-image-prior), or use the synthetic images instead "
        "(dip_tpu_torch.data.synthetic, or any PNG through the CLI's --image flag).")
