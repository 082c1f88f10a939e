"""Offline tools of the port (counterparts of the JAX package's
tools/train_backbone.py and tools/reproduce.py), each runnable as
`python -m dip_tpu_torch.tools.<name> ...` with the JAX tool's flags plus
`--device` ('cuda' by default). They write to results_torch/ at the root
of the checkout."""

import os

OUTDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "results_torch")
