"""The fit engine."""

from dip_tpu_torch.fit.engine import Engine, FitConfig, FitState, fit, init_fit

__all__ = ["Engine", "FitConfig", "FitState", "fit", "init_fit"]
