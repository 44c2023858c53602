#!/usr/bin/env python3
"""The benchmark of presto_tpu_torch on one H100 (see ``harness/bench.py``).

    python3 perfbench/run.py --workload tpch-sf1.power --seed 7 \
        --seconds 10 --trace 0

Exits non-zero, printing no result, without a CUDA card.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches stay at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
sys.path[:0] = [HERE, ROOT]

from harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
