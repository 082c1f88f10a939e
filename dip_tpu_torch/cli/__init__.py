from dip_tpu_torch.cli.main import main

__all__ = ["main"]
