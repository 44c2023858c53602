#!/usr/bin/env python3
"""One of ``chip_smoke.py``'s statement phases alone, on one CUDA card.

    python3 tools/phase_probe.py strings_dates
    python3 tools/phase_probe.py aggregates_patterns
    python3 tools/phase_probe.py nested

Builds the kernels, uploads the SF1 columns the phase reads (timed
apart, so that no statement's first run carries the upload), runs the
phase (each statement of its ``np_tpch_oracle`` table: one warm-up and
3 timed runs, every run equal to its oracle, both kernels required) and
measures the phase's captured launches in ``measure_apart``'s fresh
process.  Prints the phase's lines, a ``phase`` line with its seconds
and launch counts, the ``measure`` lines and the card's name and power
limit.  It runs on the card only.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# phase → (the ``chip_smoke`` function, the columns its statements read)
PHASES = {
    "strings_dates": ("strings_dates_phase", {
        "lineitem": ("l_comment", "l_orderkey", "l_shipdate",
                     "l_receiptdate"),
        "orders": ("o_orderkey", "o_orderdate", "o_orderpriority",
                   "o_orderstatus", "o_totalprice"),
        "customer": ("c_phone", "c_name"), "part": ("p_name",)}),
    "aggregates_patterns": ("aggregates_patterns_phase", {
        "lineitem": ("l_returnflag", "l_linestatus", "l_quantity",
                     "l_discount", "l_partkey", "l_suppkey", "l_orderkey",
                     "l_extendedprice", "l_shipmode", "l_linenumber",
                     "l_shipdate", "l_receiptdate"),
        "orders": ("o_orderkey", "o_custkey", "o_orderdate",
                   "o_orderpriority", "o_totalprice")}),
    "nested": ("nested_phase", {
        "part": ("p_name",),
        "lineitem": ("l_orderkey", "l_shipmode", "l_returnflag",
                     "l_extendedprice", "l_shipdate"),
        "orders": ("o_orderkey", "o_custkey", "o_totalprice",
                   "o_orderpriority"),
        "nation": ("n_name", "n_nationkey", "n_regionkey"),
        "region": ("r_regionkey", "r_name")}),
}


def main(argv) -> int:
    if len(argv) != 1 or argv[0] not in PHASES:
        print(f"usage: phase_probe.py {{{','.join(PHASES)}}}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("phase_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    import chip_smoke as CS
    import np_tpch_oracle as NO
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.ops import cuda_kernels as CK

    func, columns = PHASES[argv[0]]
    card = CS.card_line()
    t0 = time.perf_counter()
    CK.build()
    CS.say("build", seconds=round(time.perf_counter() - t0, 3))
    runner = LocalRunner(scale_factor=CS.SF)
    t0 = time.perf_counter()
    for table, cols in columns.items():
        runner.datasource.scan(table, cols)
    CS.say("ingest", seconds=round(time.perf_counter() - t0, 3))
    t0 = time.perf_counter()
    phase = getattr(CS, func)(torch, CK, NO, runner, card)
    CS.say("phase", name=argv[0], seconds=round(time.perf_counter() - t0, 3),
           **{k: v for k, v in phase.items() if k.endswith("launches")})
    for shape in CS.measure_apart(torch, phase["captured"]):
        CS.say("measure", **shape)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
