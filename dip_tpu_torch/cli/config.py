"""YAML config for the CLI (counterpart of dip_tpu/cli/config.py): a fit is
reproducible from one file,

    task: denoise
    image: f16.png
    preset: f16
    sigma: 25
    num_iter: 3000
    out: denoised.png

`python -m dip_tpu_torch fit --config run.yaml` (flags still override).
PyYAML is imported only when a config is read.
"""

from __future__ import annotations

from typing import Any


def load_config(path: str) -> dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if not isinstance(cfg, dict):
        raise ValueError(f"config {path!r} must be a mapping")
    return {k.replace("-", "_"): v for k, v in cfg.items()}


def apply_config(args, cfg: dict[str, Any], parser_defaults: dict[str, Any]):
    """Fill argparse namespace fields from the config where the user did not
    pass an explicit flag (the field still equals its parser default)."""
    for key, val in cfg.items():
        if not hasattr(args, key):
            raise ValueError(f"unknown config key {key!r}")
        if getattr(args, key) == parser_defaults.get(key):
            setattr(args, key, val)
    return args
