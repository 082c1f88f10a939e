"""Evaluation harnesses: the SR table protocol."""

from dip_tpu_torch.eval.sr_eval import eval_sr_dataset, psnr_y_bbox_protocol

__all__ = ["eval_sr_dataset", "psnr_y_bbox_protocol"]
