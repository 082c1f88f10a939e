"""Workloads: a TaskSpec per task, and run_task (counterpart of
dip_tpu/tasks)."""

from dip_tpu_torch.tasks import (activation_maximization, denoise, feature_inversion,
                                 flash_no_flash, inpaint, restore, super_resolve)
from dip_tpu_torch.tasks.base import TaskSpec, run_task

__all__ = ["TaskSpec", "run_task", "denoise", "inpaint", "super_resolve", "restore",
           "flash_no_flash", "feature_inversion", "activation_maximization"]
