"""The benchmark's own tests (``python -m pytest perfbench/tests``): the
harness's packages (``harness``, ``reference``) and the program sit on
the path as ``perfbench/run.py`` puts them."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# several test processes share the CPU: one torch thread each, as the
# repository's own CPU test modules run
import torch  # noqa: E402

torch.set_num_threads(1)

def tiny_cell(workload="tpch-sf1.power", root=ROOT):
    """``workload`` with its configuration cut to SF0.01 (and the row
    counts the generator makes there)."""
    from harness import spec
    from reference import tpch_gen
    cell = spec.load_cell(workload, root=root)
    cell.config = dict(cell.config, scale_factor=0.01,
                       tables=tpch_gen.row_counts(0.01))
    return cell
