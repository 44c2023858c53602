#!/usr/bin/env python3
"""``chip_smoke.py``'s ``strings_dates`` phase alone, on one CUDA card.

    python3 tools/strings_dates_probe.py

Builds the kernels, uploads the SF1 lineitem, orders, customer and part
columns the phase reads (timed apart, so that no statement's first run
carries the upload), runs ``chip_smoke.strings_dates_phase`` (each
statement of ``np_tpch_oracle.STRINGS_DATES``: one warm-up and 3 timed
runs, every run equal to its oracle, both kernels required) and measures
the phase's two captured launches in ``measure_apart``'s fresh process.
Prints the phase's lines, the ``measure`` lines and the card's name and
power limit.  It runs on the card only.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the columns the statements read, one upload each
COLUMNS = {"lineitem": ("l_comment", "l_orderkey", "l_shipdate",
                        "l_receiptdate"),
           "orders": ("o_orderkey", "o_orderdate", "o_orderpriority",
                      "o_orderstatus", "o_totalprice"),
           "customer": ("c_phone", "c_name"), "part": ("p_name",)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("strings_dates_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]
    import chip_smoke as CS
    import np_tpch_oracle as NO
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.ops import cuda_kernels as CK

    card = CS.card_line()
    t0 = time.perf_counter()
    CK.build()
    CS.say("build", seconds=round(time.perf_counter() - t0, 3))
    runner = LocalRunner(scale_factor=CS.SF)
    t0 = time.perf_counter()
    for table, cols in COLUMNS.items():
        runner.datasource.scan(table, cols)
    CS.say("ingest", seconds=round(time.perf_counter() - t0, 3))
    phase = CS.strings_dates_phase(torch, CK, NO, runner, card)
    for shape in CS.measure_apart(torch, phase["captured"]):
        CS.say("measure", **shape)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
