#!/usr/bin/env python3
"""The control's readings, from which the ``correct`` limits are set.

    python3 perfbench/check_control.py --workload tpch-sf1.power \
        --seeds 21 22 23

The control is the cell's reference computed in the nearest precision
below the configuration's exact decimals (``Tables(low_precision=True)``:
every decimal sum and division in float64), put in the program's place.
For each seed it answers the cell's stream with the parameters drawn
from that seed, and the harness's own comparison (``bench.judge``)
judges it against the exact reference: one JSON line per seed with the
number of statements wrong. The program's readings come from
``perfbench/run.py`` itself, which checks every statement it answers;
the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import bench  # noqa: E402
from harness import params as P  # noqa: E402
from harness.spec import load_cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = load_cell(args.workload)
    device = "cuda"
    sf = float(cell.config["scale_factor"])
    stream = [str(q) for q in cell.traffic["stream"]]
    ref = cell.reference()
    host = cell.generator().generate(sf, device)
    exact = ref.Tables(host, device)
    control = ref.Tables(host, device, low_precision=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        drawn = P.draw_statements(cell.statements, sf, seed)
        results = bench.Results()
        for q in stream:
            cols, rows = ref.answer(control, q, drawn[q][1])
            results.keep({"query": q, "set": 0, "failed": None,
                          "columns": cols, "rows": rows})
        whys = []
        check = bench.judge(ref, exact, results, cell.statements, [drawn],
                            lambda s: whys.append(s) if " wrong: " in s
                            else None)
        print(json.dumps({"workload": args.workload, "kind": "control",
                          "seed": seed, "statements": len(stream),
                          **check, "wrong": [w[:200] for w in whys],
                          "seconds": time.perf_counter() - t0,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
