"""Hook-free feature matcher (counterpart of dip_tpu/pretrained/matcher.py).

The backbone returns tagged activations; `store()` turns them into target
statistics (detached: targets are constants), `losses()` compares fresh
activations against stored targets, or runs the activation-maximization
objectives.
"""

from __future__ import annotations

import torch

from dip_tpu_torch.ops.losses import gram_matrix


def _features(x):
    return x


def _stat_fn(how: str):
    if how == "features":
        return _features
    if how == "gram_matrix":
        return lambda x: gram_matrix(x) if x.dim() == 4 else x
    raise ValueError(f"unknown statistic {how!r}")


def _smooth_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = torch.abs(a - b)
    return torch.mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


def _loss_fn(name: str):
    if name == "mse":
        return lambda a, b: torch.mean((a - b) ** 2)
    if name == "L1":
        return lambda a, b: torch.mean(torch.abs(a - b))
    if name == "smoothL1":
        return _smooth_l1
    raise ValueError(f"unknown loss {name!r}")


class Matcher:
    """Feature/Gram matcher with 'match' and 'maximize' objectives.

    how: 'features' | 'gram_matrix'; loss: 'mse' | 'L1' | 'smoothL1';
    method: 'match' (against stored targets) or 'maximize' / 'am_match'
    (the activation-maximization objectives, driven by map_index and
    window_size).
    """

    def __init__(self, how: str = "features", loss: str = "mse",
                 map_index: int | None = None, method: str = "match",
                 window_size: int = 20):
        self.get_statistics = _stat_fn(how)
        self.loss = _loss_fn(loss)
        self.map_index = map_index
        self.method = method
        self.window_size = window_size

    def store(self, acts: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The target statistics, detached."""
        return {k: self.get_statistics(v).detach() for k, v in acts.items()}

    def losses(self, acts: dict[str, torch.Tensor],
               stored: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        out = {}
        for name, v in acts.items():
            stats = self.get_statistics(v)
            if self.method == "match":
                if stored is None:
                    raise ValueError("match mode needs stored targets")
                out[name] = self.loss(stats, stored[name])
            elif stats.dim() == 2:
                # fc activation: single-unit objective
                if self.method == "maximize":
                    out[name] = -stats[0, self.map_index]
                else:  # 'am_match'
                    out[name] = torch.abs(300.0 - stats[0, self.map_index])
            else:
                # conv activation (NHWC): a window around the centre, cut
                # with Python's slice rules as the JAX package cuts it (a
                # negative start counts from the end: at h = 28, ws = 20
                # the rows are 22..27)
                ws = self.window_size
                h, w = stats.shape[1], stats.shape[2]
                s_cc = stats[:1, h // 2 - ws:h // 2 + ws, w // 2 - ws:w // 2 + ws,
                             self.map_index]
                if self.method == "maximize":
                    out[name] = -torch.sum(s_cc)
                else:
                    out[name] = torch.sum(torch.abs(200.0 - s_cc))
        return out

    def total(self, acts, stored=None) -> torch.Tensor:
        return sum(self.losses(acts, stored).values())
