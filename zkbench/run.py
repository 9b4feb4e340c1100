#!/usr/bin/env python3
"""Run one cell of the benchmark of ``tpu_zkpool_torch`` once, from the
root of a checkout:

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

prints the run's numbers that the reference compared on standard error,
and one JSON line, the result, last on standard output. Exits non-zero,
printing no result, without a CUDA card (or fewer than the cell asks for),
when a file the cell names is missing, and when the run has loaded JAX or
the JAX package.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(ROOT, "zkbench", ".cache")
# kernel build caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
sys.path.insert(0, ROOT)

from zkbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
