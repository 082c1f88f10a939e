"""The benchmark's entry: one run of one cell of BENCHMARK.json.

    python3 dipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It measures the PyTorch and CUDA port
(dip_tpu_torch) on the CUDA device the cell asks for and exits 2 without
one. The last line of stdout is the result (JSON); the numbers the
correctness check compared, each beside its limit, are the last lines of
stderr. Every build and kernel cache lives under build/ in the checkout.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# fixed cache directories inside the checkout, set before torch is imported
# (the port's own kernel library builds into build/kernels)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(CHECKOUT / "build" / sub)
# the checkout in place of this script's own directory, whose module names
# (trace, inputs, ...) must not shadow others
sys.path[0] = str(CHECKOUT)

from dipbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], CHECKOUT, T0))
