#!/usr/bin/env python3
"""Warm TPC-H Q14 with this checkout's ``sorted_probe`` against another
checkout's, in turns in one process, on one CUDA card.

    python3 tools/q14_probe_ab.py --other DIR [--rounds 6] [--runs 8]

DIR holds another checkout of the repository (for example a ``git
archive`` of the parent commit).  Its ``presto_tpu_torch/ops/
cuda_kernels.py`` is loaded as a separate module and builds its kernels
under DIR.  One ``LocalRunner(scale_factor=1.0)`` runs Q14; the module the
join calls ``sorted_probe`` through is switched between the two wrappers,
``--runs`` warm runs at a time, the order alternating over ``--rounds``.
Prints one JSON line per side: warm ms (host wall fenced with
``torch.cuda.synchronize()``; median, min, max, all runs) and the median
host ms spent inside ``sorted_probe`` per run.  Both sides must give the
same result.  It runs on the card only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("q14_probe_ab: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--runs", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.ops import cuda_kernels as CK
    from presto_tpu_torch.tpch.queries import QUERIES

    spec = importlib.util.spec_from_file_location(
        "other_cuda_kernels", os.path.join(
            args.other, "presto_tpu_torch", "ops", "cuda_kernels.py"))
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    CK.build()
    other.build()
    sides = {"this": CK.sorted_probe, "other": other.sorted_probe}
    inside = []

    def timed(fn):
        def wrapper(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            inside.append(time.perf_counter() - t0)
            return out
        return wrapper

    runner = LocalRunner(scale_factor=1.0)
    sql = QUERIES[14]
    want = runner.run_sql(sql).to_pydict()  # warm-up: generation, ingest
    for fn in sides.values():  # and each side's first launch
        CK.sorted_probe = fn
        runner.run_sql(sql)
    warm = {name: [] for name in sides}
    probe = {name: [] for name in sides}
    for r in range(args.rounds):
        for name in (("this", "other") if r % 2 == 0 else ("other", "this")):
            CK.sorted_probe = timed(sides[name])
            for _ in range(args.runs):
                inside.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = runner.run_sql(sql).to_pydict()
                torch.cuda.synchronize()
                warm[name].append((time.perf_counter() - t0) * 1e3)
                probe[name].append(sum(inside) * 1e3)
                if got != want:
                    raise AssertionError(f"{name}: {got} != {want}")
    CK.sorted_probe = sides["this"]
    for name in sides:
        print(json.dumps({
            "side": name, "warm_ms_median": statistics.median(warm[name]),
            "warm_ms_min": min(warm[name]), "warm_ms_max": max(warm[name]),
            "probe_host_ms_median": statistics.median(probe[name]),
            "warm_ms": warm[name]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
