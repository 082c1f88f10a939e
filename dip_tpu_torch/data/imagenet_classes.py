"""ImageNet class map for activation maximization (counterpart of
dip_tpu/data/imagenet_classes.py).

The reference names the maximized class from its
`data/imagenet1000_clsid_to_human.txt` (a Python-literal dict of
{class_id: "human label"}). The port reads a file of that format only from
a path the user gives: `--class-map`, `$DIP_IMAGENET_CLASSMAP`, or the
directory in `$DIP_REFERENCE_DATA`. An integer index needs no map.
"""

from __future__ import annotations

import ast
import os


def _default_paths() -> tuple[str, ...]:
    from dip_tpu_torch.data import reference_data_dir

    ref = reference_data_dir(required=False)
    return (
        os.environ.get("DIP_IMAGENET_CLASSMAP", ""),
        os.path.join(ref, "imagenet1000_clsid_to_human.txt") if ref else "",
    )


def load_class_map(path: str | None = None) -> dict[int, str]:
    """Parse a {class_id: label} map in the reference's file format (a
    Python dict literal), from `path` or else the environment's paths."""
    candidates = [path] if path else [p for p in _default_paths() if p]
    for p in candidates:
        if p and os.path.exists(p):
            with open(p) as f:
                raw = ast.literal_eval(f.read())
            return {int(k): str(v) for k, v in raw.items()}
    raise FileNotFoundError(
        "no ImageNet class map found; set DIP_IMAGENET_CLASSMAP or pass "
        f"--class-map (tried {candidates})")


def resolve_class(name_or_idx: str | int, path: str | None = None) -> tuple[int, str]:
    """Map a class index or (sub)name to (index, label).

    An integer index comes back with its label if a map is found, else with
    'class N'; a name is a case-insensitive substring of the label ('zebra'
    -> (340, 'zebra')). Ambiguous substrings raise with candidates.
    """
    if isinstance(name_or_idx, int) or str(name_or_idx).lstrip("-").isdigit():
        idx = int(name_or_idx)
        try:
            return idx, load_class_map(path).get(idx, f"class {idx}")
        except FileNotFoundError:
            return idx, f"class {idx}"
    cmap = load_class_map(path)
    needle = str(name_or_idx).lower()
    exact = [(i, s) for i, s in cmap.items() if needle == s.lower()]
    if exact:
        return exact[0]
    hits = [(i, s) for i, s in cmap.items() if needle in s.lower()]
    if not hits:
        raise KeyError(f"no ImageNet class matches {name_or_idx!r}")
    if len(hits) > 1:
        # prefer a comma-separated alias match ('zebra' in 'zebra')
        alias = [(i, s) for i, s in hits
                 if needle in [a.strip().lower() for a in s.split(",")]]
        if len(alias) == 1:
            return alias[0]
        raise KeyError(f"ambiguous class {name_or_idx!r}: "
                       + "; ".join(f"{i}={s}" for i, s in hits[:8]))
    return hits[0]
