#!/usr/bin/env python3
"""Where one warm query's time goes in presto_tpu_torch, on one CUDA card.

    python3 tools/torch_query_profile.py [--sf 1.0] [--runs 3] \
        [--queries q1,q6,q14,bigint_sum,q2,q3] [--tpcds q4,q11]

For the named requests (TPC-H queries and the BIGINT sum; by default the
22 queries and the sum, as ``chip_smoke.py`` orders them; with
``--tpcds``, those TPC-DS queries, over the TPC-DS connector at the same
scale factor, and TPC-H ones only where ``--queries`` names them), after
one warm-up run each, prints one JSON line per query with:

- ``wall_ms``: host wall time of one warm ``run_sql`` (median of ``runs``),
  fenced with ``torch.cuda.synchronize()``;
- ``device_busy_ms`` / ``idle_share``: the summed duration of every CUDA
  kernel, memset and memcpy that ``torch.profiler`` recorded during one run,
  and 1 - busy / wall;
- ``device_ops``: that run's count of device activities;
- ``top_device``: the five ATen operators with the most device time;
- ``scatter_ops``: device ms and calls of the colliding scatters
  (``index_add_`` of the segment sums and counts, ``scatter_reduce_`` of
  the segment min/max and ``arbitrary``);
- ``host_top``: the five functions of the port's ``ops`` package with the
  most cumulative host time under ``cProfile``, as shares of the run (a
  separate run; cProfile slows Python, so these are shares, not times);
- ``peak_bytes``: the most device memory one warm run held above what was
  allocated before it (``torch.cuda.max_memory_allocated``);
- ``groupid_out``: rows and bytes (distinct tensor storages) of each
  GROUPING SETS expansion (``physical._groupid``) of that run.

It runs on the card only and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

BIGINT_SUM = ("SELECT sum(l_orderkey) AS s, count(*) AS c FROM lineitem "
              "WHERE l_shipdate <= DATE '1998-09-02'")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_query_profile: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--queries", default=None)
    ap.add_argument("--tpcds", default="")
    args = ap.parse_args()
    if args.queries is None:
        args.queries = "" if args.tpcds else "q1,q6,q14,bigint_sum," + \
            ",".join(f"q{q}" for q in range(2, 23) if q not in (6, 14))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from presto_tpu_torch.exec import physical as P
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.tpcds import generator as DSG
    from presto_tpu_torch.tpcds.queries import QUERIES as DS_QUERIES
    from presto_tpu_torch.tpch.queries import QUERIES
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    runner = LocalRunner(scale_factor=args.sf)
    requests = {name: BIGINT_SUM if name == "bigint_sum"
                else QUERIES[int(name[1:])]
                for name in filter(None, args.queries.split(","))}
    if args.tpcds:
        # TPC-DS tables shadow TPC-H's same-named ones (customer)
        DSG.attach(runner, args.sf)
        requests.update({f"tpcds_{name}": DS_QUERIES[int(name[1:])]
                         for name in args.tpcds.split(",")})
    groupid_out = []
    expand = P._groupid

    def recorded_groupid(*args):
        out = expand(*args)
        tensors = {t.data_ptr(): t.numel() * t.element_size() for c in
                   out.cols.values() for t in (c.values, c.lengths,
                                               c.validity) if t is not None}
        groupid_out.append({"rows": out.n_rows, "bytes": sum(
            tensors.values()) + out.mask.numel()})
        return out

    P._groupid = recorded_groupid
    for name, sql in requests.items():
        runner.run_sql(sql)  # warm-up: generation, ingest, kernel build
        walls = []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.run_sql(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)

        groupid_out.clear()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runner.run_sql(sql)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        expansions = list(groupid_out)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            runner.run_sql(sql)
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        by_op = sorted((a for a in prof.key_averages()
                        if a.key.startswith("aten::")),
                       key=lambda a: a.self_device_time_total, reverse=True)
        top_device = [(a.key, round(a.self_device_time_total / 1e3, 4),
                       a.count) for a in by_op[:5]
                      if a.self_device_time_total > 0]
        scatter_ops = {a.key: (a.self_device_time_total / 1e3, a.count)
                       for a in by_op if a.key in (
                           "aten::index_add_", "aten::scatter_reduce_")}

        cp = cProfile.Profile()
        cp.enable()
        runner.run_sql(sql)
        torch.cuda.synchronize()
        cp.disable()
        st = pstats.Stats(cp)
        total = max(st.total_tt, 1e-9)
        port = [(f"{os.path.basename(f)}:{fn}", ct) for (f, _, fn), (
            _, _, _, ct, _) in st.stats.items()
            if os.path.join("presto_tpu_torch", "ops") in f]
        port.sort(key=lambda x: x[1], reverse=True)
        host_top = [(k, round(ct / total, 3)) for k, ct in port[:5]]

        print(json.dumps({
            "query": name, "sf": args.sf, "wall_ms": wall, "walls_ms": walls,
            "device_busy_ms": busy_ms if dev else "not measured",
            "idle_share": (1 - busy_ms / wall) if dev else "not measured",
            "device_ops": len(dev), "host_syncs": runner.last_host_syncs,
            "top_device": top_device, "scatter_ops": scatter_ops,
            "host_top": host_top, "peak_bytes": peak,
            "groupid_out": expansions,
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
