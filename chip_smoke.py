#!/usr/bin/env python3
"""Drive presto_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the script exits
non-zero without printing a result):

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: compile every CUDA kernel from ``presto_tpu_torch/csrc``;
3. kernels: each kernel's wrapper on card tensors, exactly equal to its
   plain PyTorch version at edge cases;
4. queries: ``LocalRunner(scale_factor=1.0)`` on cuda runs all 22 TPC-H
   queries and a BIGINT sum through ``run_sql`` (one warm-up, then 5
   timed runs each, the last one's peak bytes kept for phase 9), every
   result equal to a numpy oracle over the same
   generated tables (``tools/np_tpch_oracle.py``); the kernels' launch
   counts are reset just before and read just after, each kernel must
   have launched, and ``sorted_probe`` must have launched in every query
   of ``PROBED`` (each has a join on one BIGINT key);
4b. distributed: a world of one rank over NCCL (a rank process of
   ``python -m presto_tpu_torch.parallel.worker`` started and guarded by
   ``parallel/multihost.launch_world``) runs phase 4's 23 requests
   through ``DistributedRunner(scale_factor=1.0,
   broadcast_row_limit=300_000)`` (the orders- and lineitem-sized builds
   PARTITIONED): one warm-up and 3 timed runs each, every run equal to
   phase 4's numpy oracle, one ``distributed_statement`` line each (warm
   median, host syncs, collectives, bytes exchanged); with one rank every
   exchange is the identity, but every collective, dtype and device
   placement is NCCL's on the card.  The rank resets the launch counts
   when it starts and reads them at its end; ``masked_sum`` must launch in
   the BIGINT sum's partial and ``sorted_probe`` in every query of
   ``PROBED``;
4c. cluster: ``ClusterSupervisor(scale_factor=1.0, n_workers=1,
   min_workers=1, device="cuda:0", broadcast_row_limit=300_000)``
   supervises phase 4's ``q3``, ``q5`` and BIGINT sum: each statement is
   one attempt, a world of one NCCL rank started by ``launch_world``,
   whose rank 0 hands back its host ``Table``, equal to phase 4's
   oracle; one ``cluster_statement`` line each (the attempt's wall ms,
   the world's start and ingest included, rows, the rank's launches).
   The counters must read one attempt per statement and no restart, and
   the rank's launch counts (reset when it starts) must show
   ``sorted_probe`` in Q3 and ``masked_sum`` in the BIGINT sum.  One card
   holds only a world of one rank (NCCL puts no two ranks of a
   communicator on one card), so a death and its replay on the survivors
   are checked on the CPU only (``tests/test_torch_cluster.py``);
5. measure: each kernel, exactly equal to its plain version, at the
   shapes the main path gives it (``sorted_probe`` at Q14's launch, at
   the largest launch of Q3 and at the largest launch of Q4 and Q21 into
   a build with repeated keys, captured from a run of the query; also at
   SF1's lineitem -> orders probe, clustered and shuffled; ``seg_reduce``
   at Q1's largest sum and count, captured from a run of Q1, beside the
   library scatter alone), timed two ways,
   each the median of 20 samples with the kernel, its plain version and
   the library call in turns:
   - call time (``call_ms``, also ``ms``): CUDA events around 10
     back-to-back calls of the Python function, so the host's cost per
     call is in it whenever it exceeds the device's;
   - device time (``device_ms``, also ``kernel_ms``): the summed duration
     of the device activities (kernels, memsets, copies) one call makes,
     read from ``torch.profiler`` over windows of 10 calls;
   ``library_ms`` / ``library_device_ms`` are the same two times of one
   PyTorch call computing the same function;
6. like: ``strings.like`` (plain torch, no kernel of its own) on SF1's
   ``o_comment`` with Q13's pattern, its mask equal to the oracle's
   ``str.find`` match, timed the same two ways;
6b. scalars: phase 4's runner and SF1 tables take the ``SCALARS``
   statements of ``tools/np_tpch_oracle.py`` (IN over a decimal, NOT IN
   with a NULL, ``mod``, ``nullif``, ``greatest``/``least``, ``length``
   and ``lower`` of a DICT and of a BYTES column, min/max of DICT columns
   by return flag, ``sum(sqrt(..))``/``sum(ln(..))``, a ``bitwise_and``
   BIGINT sum that launches ``masked_sum``, a join on the BIGINT order
   key filtered by a decimal IN that launches ``sorted_probe``, and
   ``count(distinct unique_id())``), one warm-up and 3 timed runs each,
   every run equal to the numpy oracle (DOUBLE sums to 1e-12 relative of
   ``math.fsum``); one line per statement with its warm median, host
   syncs and launches; launch counts are reset just before the phase and
   read just after, and both kernels must launch in it; the inputs of
   each kernel's largest launch in the phase are captured, held to the
   plain version and measured in the fresh process of phase 7;
6c. strings_dates: the same runner and tables take the ``STRINGS_DATES``
   statements of ``tools/np_tpch_oracle.py`` the same way (one warm-up
   and 3 timed runs each, every run equal to its numpy/Python oracle,
   one ``strings_dates_statement`` line each, launches reset at the
   phase's start, both kernels required, each one's largest launch
   captured): byte-matrix trim, ``strpos``, ``reverse``, ``rpad``,
   ``starts_with``/``ends_with`` and ``codepoint`` over lineitem's
   comments and the customers, ``regexp_like``/``regexp_extract`` over
   the part names (decoded on the host), ``split_part`` (a NULL past the
   last field) and ``to_hex`` of dictionary columns, ``quarter``,
   ``day_of_week``, ``date_diff`` over the lineitem ⋈ orders join (its
   negative month and week spans truncated toward zero, as Trino's),
   ``date_format`` of ``date_trunc``, ISO weeks, ``date_add`` against
   ``last_day_of_month`` and zoned timestamps (the hour in the zone, the
   instant kept);
6d. aggregates_patterns: the same runner and tables take the
   ``AGGREGATES_PATTERNS`` statements of ``tools/np_tpch_oracle.py`` the
   same way (one ``aggregates_patterns_statement`` line each, both
   kernels required, each one's largest launch captured): bool_and/or,
   bitwise_and/or_agg, checksum and count over lineitem by return flag
   and line status; the corr family of (price, quantity) and
   geometric_mean by return flag (DOUBLEs to 1e-12 relative of exact
   rational moments and ``math.fsum`` logarithms, the largest relative
   error printed); exact grouped and global approx_percentile;
   min_by/max_by keyed by a DATE (the JAX package's fault) and over
   lineitem ⋈ orders keyed by a value unique per row (``sorted_probe``);
   a global checksum (``masked_sum``); MATCH_RECOGNIZE ONE ROW and ALL
   ROWS PER MATCH over 1.5 M orders, summed, against ``re.finditer``.
   Then ``AGGREGATES_STREAMED`` through ``run_sql_streaming`` (131072
   order units a slice, at least 8 slices), equal to the oracle, one
   ``aggregates_streamed`` line each;
6e. nested: the same runner and tables take the ``NESTED`` statements of
   ``tools/np_tpch_oracle.py`` the same way (one ``nested_statement``
   line each, both kernels required, each one's largest launch
   captured): UNNEST of ``split(p_name, ' ')`` (200,000 names, 1,000,000
   words) grouped, WITH ORDINALITY, ``contains``/``array_distinct``/
   ``array_position`` summed as BIGINTs (``masked_sum``), the string set
   operations sorted and joined (strings compared across dictionaries),
   ``array_agg`` of 1.5 M orders by customer, ``histogram`` over
   lineitem ⋈ orders (``sorted_probe``), ``max(x, n)``/``min(x, n)`` by
   return flag, ``map_agg`` and ``element_at`` by region and a ROW folded
   at the edge, each equal to Python/numpy;
7. tpcds: the TPC-DS connector at SF1 loads all 24 tables onto the card;
   all 99 TPC-DS queries (``tpcds.queries.RUNS``, windows and GROUPING
   SETS among them) run through ``run_sql`` (one warm-up, then 3 timed
   runs each; launch counts reset just before and read just after, its
   host syncs printed per query, ``sorted_probe`` required in
   every query but ``TPCDS_UNPROBED``); ``sorted_probe`` is measured, in
   a fresh process of this script (``measure_apart``), at the launch of
   those queries with the most probes, and at the one with the most
   probes into a build of 2^16 or more keys; every SF1 result
   (each run) equals the port's own CPU run over the same generated
   tables, DOUBLE columns to 1e-9 relative; and the 99 queries on the card
   at SF0.02 equal SQLite under the JAX package's battery rule
   (``tools/sqlite_tpcds_oracle.py``; the SQLite step runs in a thread
   beside the CPU step);
8. server: ``connect(schema="sf1")`` on the card behind a
   ``StatementServer`` (loopback, one resource group admitting one
   statement at a time, 64 queued): four client threads at once send the
   22 TPC-H queries and the BIGINT sum over HTTP (``HttpClient``: POST,
   then ``nextUri``), 92 statements, each FINISHED and equal to its numpy
   oracle as the protocol renders it (decimals as scaled strings, dates
   ISO); then one client, each request's warm HTTP time beside its DB-API
   cursor and ``run_sql`` times; a statement of three pages; a memory
   table of millions of lineitem rows written over HTTP (CTAS, INSERT,
   UPDATE, DELETE, SHOW TABLES / STATS, a rolled-back DB-API transaction,
   DROP with the pool's ``used`` back), each step held to numpy and
   ``masked_sum`` and ``sorted_probe`` launched by its sum and join, the
   inputs of each one's largest launch captured; EXPLAIN ANALYZE of Q3;
   an unknown table and a syntax error.  Launch counts are reset before
   the first HTTP statement and read after the last.  The two captured
   launches are held to their plain versions and measured with the
   TPC-DS ones, in the one fresh process of phase 7, after this phase;
9. tiers: the memory tiers on the card.  Budgeted SF1: phase 4's runner
   takes each request of phase 4 and an ORDER BY of all 1,500,000 orders
   (``TIERS_SORT``) in turn: one run at the default budget (its columns
   cached), then the pool's budget set to its ``used`` bytes plus
   ``TIERS_HEADROOM`` (64 MiB), so that a large join, aggregation or sort
   runs one partition at a time; one warm-up and 3 timed runs, each equal
   to the oracle (the ORDER BY to ``np.lexsort``), printed with
   ``last_spill_partitions``, host syncs and peak bytes beside phase 4's
   free-path time and peak.  Q1's aggregation, the ORDER BY and at least
   ``TIERS_MIN_JOINS`` join queries must partition; the largest
   ``sorted_probe`` launch inside a partitioned join is captured and
   measured in the fresh process of phase 7.  Streamed SF10:
   ``run_sql_streaming`` with ``STREAM_SLICE`` order units a slice (15
   slices of lineitem) on Q1, Q6 and the ``STREAMED`` statements (a
   BIGINT sum that launches ``masked_sum``, ``approx_distinct`` by
   return flag, 15,000,000 groups by order key, a split-pruned orders
   query and one pruned by a decimal bound on the key, each reading at
   most 3 slices), each equal to numpy over the same
   generated host tables (``np_tpch_oracle``), nothing of the table
   cached; then Q1 on the resident path (bounded ingest of the same
   slices), equal too, and the streamed Q1's peak must stay under half
   the resident scan's bytes.  Launch counts of both paths are read
   around their runs;
10. a ``kernels`` JSON line (launches by path: tpch, scalars,
    strings_dates, aggregates_patterns, aggregates_streamed, nested,
    distributed, cluster, tpcds, server, tiers, streamed), then the card
    line,
    then the result line
    ``{"ok": true, "device": {...}}``.

It exits non-zero without a CUDA device, and in a directory that holds
no ``presto_tpu_torch`` package.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
SAMPLES = 20               # timing samples per measurement (median kept)
CALLS = 10                 # back-to-back calls per timing sample
TIMED_RUNS = 5             # timed runs per query after one warm-up
SF = 1.0
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

BIGINT_SUM = ("SELECT sum(l_orderkey) AS s, count(*) AS c FROM lineitem "
              "WHERE l_shipdate <= DATE '1998-09-02'")
OTHER_QUERIES = (2, 3, 4, 5, 7, 8, 9, 10, 11, 12, 13, 15, 16, 17, 18, 19,
                 20, 21, 22)
# queries that must launch sorted_probe: each has a join on one BIGINT key
PROBED = ("q3", "q4", "q21", "q7", "q8", "q9", "q11", "q12", "q13", "q15",
          "q16", "q19", "q20", "q22")
REPLACES = {"masked_sum": "presto_tpu/ops/pallas_kernels.py:103",
            "sorted_probe": "presto_tpu/ops/pallas_kernels.py:196",
            # no TPU kernel: the segment reductions' colliding scatters
            "seg_reduce": "index_add_ / scatter_reduce_ (ops/agg.py)"}
TPCDS_SF = 1.0             # the smallest scale the TPC-DS spec defines
TPCDS_CHECK_SF = 0.02      # the scale held to SQLite
TPCDS_TIMED_RUNS = 3
DOUBLE_REL = 1e-9          # DOUBLE columns: atomics reorder the sums
# TPC-DS queries that launch no sorted_probe: q9 joins nothing (it reads
# store_sales and reason through scalar subqueries); q41's one join is a
# self-join of item on the BYTES column i_manufact, whose keys are several
# 8-byte packs (the lexicographic search, not the kernel)
TPCDS_UNPROBED = (9, 41)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, sort_keys=True), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(torch, fns: dict) -> dict:
    """Call time: for each function, the median over SAMPLES of the
    per-call time of CALLS back-to-back calls, bracketed by CUDA events,
    the functions taken in turns.  Where the host needs longer per call
    than the device, this is the host's call rate."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(SAMPLES):
        for name, fn in fns.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(CALLS):
                fn()
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1) / CALLS)
    return {name: statistics.median(t) for name, t in times.items()}


def _device_events(torch, run) -> list:
    """The device activities (kernels, memsets, copies) that
    ``torch.profiler`` recorded while ``run()`` ran, in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def device_ms(torch, fns: dict) -> dict:
    """Device time: for each function, the median over SAMPLES of the
    summed duration of the device activities of CALLS calls, per call,
    each sample one ``torch.profiler`` window, the functions in turns.
    The profiler now and then drops an activity or a whole window's: a
    window whose count is not a multiple of CALLS is taken again, its
    activities by name printed as a ``profiler`` line, and after five such
    windows in a row the script fails."""
    def window(fn) -> float:
        def run():
            for _ in range(CALLS):
                fn()
        for _ in range(5):
            events = _device_events(torch, run)
            if events and len(events) % CALLS == 0:
                return sum(e.time_range.elapsed_us()
                           for e in events) / CALLS / 1e3
            names = {}
            for e in events:
                names[e.name] = names.get(e.name, 0) + 1
            say("profiler", calls=CALLS, activities=len(events), names=names)
        raise AssertionError(f"profiler: {len(events)} device activities "
                             f"in a window of {CALLS} calls: {names}")

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(SAMPLES):
        for name, fn in fns.items():
            times[name].append(window(fn))
    return {name: statistics.median(t) for name, t in times.items()}


# ---------------------------------------------------------------- kernels

def check_masked_sum(torch, CK, values, mask, label):
    got = CK.masked_sum(values, mask)
    torch.cuda.synchronize()
    want = CK.masked_sum_plain(values, mask)
    err = abs(int(got) - int(want))
    if err:
        raise AssertionError(f"masked_sum {label}: kernel {int(got)} != "
                             f"plain {int(want)}")
    return err


def check_sorted_probe(torch, CK, keys, probes, n_valid, label):
    got = CK.sorted_probe(keys, probes, n_valid)
    torch.cuda.synchronize()
    want = CK.sorted_probe_plain(keys, probes, n_valid)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if probes.numel() else 0
    if err:
        raise AssertionError(f"sorted_probe {label}: max |diff| {err}")
    return err


def sample_positions(n_valid: int, size: int):
    """The key positions a sample of ``size`` (a power of two) evenly
    spaced keys of [0, n_valid) takes: ((j+1) n_valid / size) - 1, or every
    position when the valid keys fit."""
    import torch
    j = torch.arange(min(n_valid, size), dtype=torch.int64)
    if n_valid <= size:
        return j
    return (((j + 1) * n_valid) >> (size.bit_length() - 1)) - 1


def probe_edge_cases(torch, CK, dev, gen) -> int:
    """``sorted_probe`` against its plain version on a table of random keys,
    one of long runs of equal keys (runs of ~5,000 cross every sample
    position) and one where every key repeats 2-7 times (a non-unique
    build's runs, crossing sample positions), at every n_valid in {0, 1, 2, 123457, 200000} and S-1, S,
    S+1 for every sample size S, with garbage beyond n_valid, probes equal
    to (and one off) the sampled keys, random probes and int64 min/max, P
    in {1, 255, 257, 1M}; n_valid passed as an int, an int64 device scalar
    and an int32 device scalar in turns.  Returns the checks made."""
    n, lo64, hi64 = 200_000, -2**63, 2**63 - 1
    # every sample size the kernel's launch plan can choose
    sizes = tuple(1 << b for b in range(CK.SAMPLE_LOG2[0],
                                        CK.SAMPLE_LOG2[1] + 1))
    tables = {
        "random": torch.randint(-10**12, 10**12, (n,), generator=gen),
        "runs": torch.randint(0, 40, (n,), generator=gen) * 1000 - 20_000,
        # every key repeats 2-7 times, as l_orderkey does in lineitem
        "repeats": torch.repeat_interleave(
            torch.arange(n) * 3 - n,
            torch.randint(2, 8, (n,), generator=gen))[:n]}
    n_valids = sorted({0, 1, 2, 123_457, n} | {
        s + d for s in sizes for d in (-1, 0, 1)})
    checks = 0
    for tname, table in tables.items():
        table = torch.sort(table).values
        for n_valid in n_valids:
            keys = table.clone()
            keys[n_valid:] = torch.randint(lo64, hi64, (n - n_valid,),
                                           generator=gen)
            keys[n_valid::7] = hi64  # garbage includes the extremes
            keys[n_valid + 3::7] = lo64
            sampled = torch.cat([keys[sample_positions(n_valid, s)]
                                 for s in sizes])
            pool = torch.cat([
                sampled, sampled - 1, sampled + 1,
                keys[torch.randint(0, max(n_valid, 1), (4096,),
                                   generator=gen)],
                torch.randint(-2 * 10**12, 2 * 10**12, (4096,),
                              generator=gen)])
            pool = torch.cat([torch.tensor([lo64, hi64]),
                              pool[torch.randperm(pool.shape[0],
                                                  generator=gen)]])
            d_keys = keys.to(dev)
            for p in (1, 255, 257, 1_000_000):
                probes = pool[torch.randint(0, pool.shape[0], (p,),
                                            generator=gen)]
                probes[:min(p, pool.shape[0])] = pool[:p]
                nv = (n_valid, torch.tensor(n_valid, device=dev),
                      torch.tensor(n_valid, dtype=torch.int32,
                                   device=dev))[checks % 3]
                check_sorted_probe(torch, CK, d_keys, probes.to(dev), nv,
                                   f"{tname} n_valid={n_valid} P={p}")
                checks += 1
    return checks


def edge_cases(torch, CK, dev) -> None:
    gen = torch.Generator(device="cpu").manual_seed(7)
    big = 2**62
    for n in (0, 1, 8191, 6_000_000):
        v = torch.randint(-big, big, (n,), generator=gen).to(dev)
        for density in (0.0, 0.4, 1.0):
            m = (torch.rand((n,), generator=gen) < density).to(dev)
            check_masked_sum(torch, CK, v, m, f"n={n} density={density}")
    say("kernels", kernel="masked_sum", edge_cases="n in 0,1,8191,6M x "
        "density 0,0.4,1, |v| < 2^62", max_abs_err=0)
    checks = probe_edge_cases(torch, CK, dev, gen)
    say("kernels", kernel="sorted_probe", edge_cases="random, long-run "
        "and every-key-repeats keys (n=200k), garbage beyond n_valid, n_valid in "
        "0,1,2,123457,200000 and S-1,S,S+1 for every sample size S, "
        "probes = sampled keys +-1, random, int64 min/max, P in "
        "1,255,257,1M", checks=checks, max_abs_err=0)


def path_inputs(torch, runner):
    """The kernels' inputs as the main path forms them, at SF1: the BIGINT
    sum's l_orderkey column with its filter mask (masked_sum); Q14's
    sorted part keys against the lineitem part keys of its month
    (sorted_probe, Q14's launch); and the unfiltered form of the
    lineitem -> orders foreign-key probe of Q3, Q5, Q10, Q18 and Q21, all
    of l_orderkey into the sorted o_orderkey, in table order (clustered)
    and in a fixed random order (seed 0)."""
    from np_tpch_oracle import days
    ds = runner.datasource
    li = ds.scan("lineitem", ("l_orderkey", "l_partkey", "l_shipdate"))
    part = ds.scan("part", ("p_partkey",))
    orders = ds.scan("orders", ("o_orderkey",))
    ship = li.cols["l_shipdate"].values
    okey = li.cols["l_orderkey"].values.contiguous()
    mask = (ship <= days("1998-09-02")).contiguous()
    window = (ship >= days("1995-09-01")) & (ship < days("1995-10-01"))
    pkeys = torch.sort(part.cols["p_partkey"].values).values.contiguous()
    okeys = torch.sort(orders.cols["o_orderkey"].values).values.contiguous()
    perm = torch.randperm(okey.shape[0], generator=torch.Generator(
        device="cpu").manual_seed(0)).to(okey.device)
    probe_shapes = {
        "q14_path": (pkeys, li.cols["l_partkey"].values[window].contiguous()),
        "lineitem_orders_clustered": (okeys, okey),
        "lineitem_orders_shuffled": (okeys, okey[perm].contiguous())}
    return (okey, mask), {
        name: (keys, probes, torch.tensor(keys.shape[0], device=keys.device))
        for name, (keys, probes) in probe_shapes.items()}


def measure_masked_sum(torch, CK, okey, mask, name="bigint_sum") -> dict:
    n = okey.shape[0]
    fns = {"kernel": lambda: CK.masked_sum(okey, mask),
           "plain": lambda: CK.masked_sum_plain(okey, mask),
           "library": lambda: torch.where(mask, okey, 0).sum()}
    calls = call_ms(torch, fns)
    dev = device_ms(torch, {k: fns[k] for k in ("kernel", "library")})
    return dict(
        shape=f"{name}: N={n} int64 values + bool mask",
        max_abs_err=check_masked_sum(torch, CK, okey, mask, name),
        call_ms=calls["kernel"], device_ms=dev["kernel"],
        plain_ms=calls["plain"], library_ms=calls["library"],
        library_device_ms=dev["library"],
        bound_ms=(9 * n + 8) / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


def seg_inputs(torch, values, slot, mask, capacity: int, op: int) -> list:
    """A ``seg_reduce`` launch's inputs as ``measure_apart`` saves them:
    tensors only, a count's missing values as an empty tensor, the op by
    its code (``CK.SEG_OPS``)."""
    return [values.clone() if values is not None
            else torch.empty(0, dtype=torch.int64, device=slot.device),
            slot.clone(), mask.clone(), torch.tensor(capacity),
            torch.tensor(op)]


def capture_seg_reduce(torch, CK, run) -> dict:
    """The inputs of the largest sum and the largest count ``seg_reduce``
    launch that ``run()`` makes (by rows, as ``seg_inputs``), through a
    wrapper around ``CK.seg_reduce`` while it runs."""
    best, real = {}, CK.seg_reduce

    def record(values, slot, mask, capacity, op="add"):
        out = real(values, slot, mask, capacity, op)
        kind = "count" if values is None else op
        if kind in ("add", "count") and slot.is_cuda and capacity and \
                slot.shape[0] > best.get(kind, (-1,))[0]:
            best[kind] = (slot.shape[0], seg_inputs(
                torch, values, slot, mask, capacity, CK.SEG_OPS[op]))
        return out

    CK.seg_reduce = record
    try:
        run()
    finally:
        CK.seg_reduce = real
    return {k: v[1] for k, v in best.items()}


def seg_bound_ms(n: int, capacity: int, slot_bytes: int,
                 values: bool) -> float:
    """Least time of a segment reduction: each row's value (8 bytes, none
    for a count), slot and one-byte mask read once, the slots written."""
    return ((8 * values + slot_bytes + 1) * n + 8 * capacity) \
        / HBM_BYTES_PER_S * 1e3


def measure_seg_reduce(torch, CK, name, values, slot, mask, capacity,
                       op) -> dict:
    """``seg_reduce`` at one launch's inputs (``seg_inputs``' form): its
    plain version on the card, and the library scatter alone
    (``index_add_`` / ``scatter_reduce_`` into a spare slot, its index
    made beforehand)."""
    capacity, op = int(capacity), list(CK.SEG_OPS)[int(op)]
    values = values if values.numel() else None
    n = slot.shape[0]
    idx = torch.where(mask & (slot >= 0) & (slot < capacity),
                      slot.to(torch.int64), capacity)
    src = values if values is not None else torch.ones_like(idx)
    lib = torch.full((capacity + 1,), CK.seg_identity(op),
                     dtype=torch.int64, device=slot.device)
    library = (lambda: lib.index_add_(0, idx, src)) if op == "add" else \
        (lambda: lib.scatter_reduce_(0, idx, src, reduce="a" + op))
    fns = {"kernel": lambda: CK.seg_reduce(values, slot, mask, capacity, op),
           "plain": lambda: CK.seg_reduce_plain(values, slot, mask,
                                                capacity, op),
           "library": library}
    got = fns["kernel"]()
    want = fns["plain"]()
    torch.cuda.synchronize()
    err = int((got != want).sum())
    if err:
        raise AssertionError(f"seg_reduce {name}: {err} of {capacity} "
                             "slots differ from the plain version")
    calls = call_ms(torch, fns)
    dev = device_ms(torch, {k: fns[k] for k in ("kernel", "library")})
    plan = CK.seg_reduce_plan(n, capacity, torch.cuda.get_device_properties(
        slot.device).multi_processor_count)
    what = "count" if values is None else f"{op} of int64 values"
    return dict(
        shape=f"{name}: {what}, N={n} {slot.dtype} slots + bool mask, "
              f"capacity {capacity}",
        plan=dict(zip(("blocks", "threads", "privatised"), plan)),
        max_abs_err=err, call_ms=calls["kernel"], device_ms=dev["kernel"],
        plain_ms=calls["plain"], library_ms=calls["library"],
        library_device_ms=dev["library"],
        bound_ms=seg_bound_ms(n, capacity, slot.element_size(),
                              values is not None), bound_by="bytes")


def largest_probe(torch, CK, runner, sql, repeated: bool):
    """The inputs of the ``sorted_probe`` launch with the most probes that
    one run of ``sql`` makes into a build whose valid keys repeat
    (``repeated``) or are unique, copied as the main path gave them
    (through ``CK.set_probe_recorder``), or None when there was no such
    launch."""
    best = {}

    def record(keys, probes, n_valid):
        nv = int(n_valid)
        if bool((keys[1:nv] == keys[:max(nv - 1, 0)]).any()) == repeated \
                and probes.shape[0] > best.get("p", -1):
            best.update(p=probes.shape[0], inputs=(
                keys.clone(), probes.clone(),
                torch.tensor(nv, device=keys.device)))

    CK.set_probe_recorder(record)
    try:
        runner.run_sql(sql)
    finally:
        CK.set_probe_recorder(None)
    return best.get("inputs")


def probe_bound_ms(p: int, nv: int) -> float:
    """Least time of a lower-bound search of ``p`` probes into ``nv`` valid
    keys: the probes read (8 bytes each) and the positions written (4
    bytes each) once, and of the keys at most one 32-byte sector per probe,
    never more than the whole table (plus the 8-byte n_valid)."""
    key_bytes = 8 * min(nv, 4 * p)
    return (12 * p + key_bytes + 8) / HBM_BYTES_PER_S * 1e3


def measure_sorted_probe(torch, CK, name, keys, probes, n_valid) -> dict:
    p, k, nv = probes.shape[0], keys.shape[0], int(n_valid)
    fns = {"kernel": lambda: CK.sorted_probe(keys, probes, n_valid),
           "plain": lambda: CK.sorted_probe_plain(keys, probes, n_valid),
           "library": lambda: torch.searchsorted(keys[:nv], probes,
                                                 side="left")}
    calls = call_ms(torch, fns)
    dev = device_ms(torch, {k: fns[k] for k in ("kernel", "library")})
    return dict(
        shape=f"{name}: n={k} sorted int64 keys ({nv} valid), "
              f"P={p} int64 probes",
        max_abs_err=check_sorted_probe(torch, CK, keys, probes, n_valid,
                                       name),
        call_ms=calls["kernel"], device_ms=dev["kernel"],
        plain_ms=calls["plain"], library_ms=calls["library"],
        library_device_ms=dev["library"],
        bound_ms=probe_bound_ms(p, nv), bound_by="bytes")


def measure_like(torch, runner, NO) -> dict:
    """``strings.like`` on SF1's o_comment with Q13's pattern: its mask
    against the oracle's ``str.find`` match, and its call and device
    times.  The bound reads the byte matrix and lengths once and writes
    one byte per row."""
    from presto_tpu_torch.ops import strings as S
    pattern = "%special%requests%"
    oc = runner.datasource.scan("orders", ("o_comment",)).cols["o_comment"]
    got = S.like(oc.values, oc.lengths, pattern).cpu().numpy()
    want = NO.has_in_order(NO.Tables(runner.datasource).s(
        "orders", "o_comment"), ("special", "requests"))
    if not (got == want).all():
        raise AssertionError(f"like {pattern!r}: {int((got != want).sum())} "
                             "rows differ from the oracle")
    fns = {"like": lambda: S.like(oc.values, oc.lengths, pattern)}
    n, w = oc.values.shape
    return dict(
        shape=f"o_comment: N={n} rows x W={w} bytes, {pattern!r}",
        rows_matched=int(got.sum()), equals_oracle=True,
        call_ms=call_ms(torch, fns)["like"],
        device_ms=device_ms(torch, fns)["like"],
        bound_ms=(n * w + 5 * n) / HBM_BYTES_PER_S * 1e3, bound_by="bytes")


# ---------------------------------------------------------------- scalars

SCALARS_TIMED_RUNS = 3
SCALARS_REL = 1e-12  # DOUBLE sums of transcendental functions vs math.fsum


def record_largest(torch, kernel: str, best: dict):
    """A recorder for ``kernel`` (``CK.set_sum_recorder`` or
    ``CK.set_probe_recorder``) that keeps in ``best`` copies of the inputs
    of its launch with the most rows (values summed, or probes), as the
    path gave them."""
    def record(*inputs):
        n = inputs[1 if kernel == "sorted_probe" else 0].shape[0]
        if n > best.get("n", -1):
            best.update(n=n, inputs=[
                x.clone() if isinstance(x, torch.Tensor)
                else torch.tensor(int(x), device="cuda") for x in inputs])
    return record


def check_statement(label: str, name: str, table, want: dict,
                    doubles=(), rel: float = SCALARS_REL) -> float:
    """Raise unless ``table`` equals the oracle's ``want[name]``: exactly,
    or, for a statement in ``doubles``, its DOUBLE values to ``rel`` of
    the oracle's.  Returns the largest relative error of those values (0
    for an exact statement)."""
    got = {c: col.to_pylist() for c, col in table.columns.items()}
    w = want[name]
    if name not in doubles:
        if got != w:
            raise AssertionError(f"{label} {name}: {got} != oracle {w}")
        return 0.0
    worst = 0.0
    ok = got.keys() == w.keys() and all(len(got[c]) == len(w[c]) for c in w)
    for c in w if ok else ():
        for a, b in zip(got[c], w[c]):
            if not isinstance(b, float):
                ok = ok and a == b
                continue
            err = abs(a - b) / abs(b) if b else abs(a)
            worst = max(worst, err)
            ok = ok and err <= rel
    if not ok:
        raise AssertionError(f"{label} {name}: {got} != oracle {w}")
    return worst


def statements_phase(torch, CK, runner, card: str, label: str,
                     statements: dict, oracle, doubles=(),
                     rel: float = SCALARS_REL) -> dict:
    """Phases 6b-6e (see the module docstring): ``statements`` on
    phase 4's SF1 runner, each run equal to ``oracle()``'s result (the
    ``doubles`` to ``rel`` of it); one ``<label>_statement`` line per
    statement.  The launch counts are reset just before the first run and
    read just after the last, and both kernels must launch; the inputs of
    each kernel's largest launch in the warm-up runs are captured for
    ``measure_apart``.  Returns the launches, the captured inputs and the
    oracle's results."""
    t_phase = time.perf_counter()
    want = oracle()
    oracle_s = time.perf_counter() - t_phase
    largest = {"masked_sum": {}, "sorted_probe": {}}
    worst = {}

    def check(name, table):
        err = check_statement(label, name, table, want, doubles, rel)
        worst[name] = max(worst.get(name, 0.0), err)

    def warm_up(name, sql):
        """One run with the recorders on; a launch larger than any before
        is kept with the statement's name."""
        sizes = {k: v.get("n", -1) for k, v in largest.items()}
        found = {k: {} for k in largest}
        CK.set_sum_recorder(record_largest(torch, "masked_sum",
                                           found["masked_sum"]))
        CK.set_probe_recorder(record_largest(torch, "sorted_probe",
                                             found["sorted_probe"]))
        try:
            check(name, runner.run_sql(sql))
        finally:
            CK.set_sum_recorder(None)
            CK.set_probe_recorder(None)
        for k, f in found.items():
            if f.get("n", -1) > sizes[k]:
                largest[k] = dict(f, statement=name)

    CK.reset_launches()
    for name, sql in statements.items():
        before = dict(CK.LAUNCHES)
        warm_up(name, sql)
        runs = []
        for _ in range(SCALARS_TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table = runner.run_sql(sql)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
            check(name, table)
        per_run = {k: (CK.LAUNCHES[k] - before[k]) // (1 + SCALARS_TIMED_RUNS)
                   for k in CK.LAUNCHES}
        extra = {"max_rel_err": worst[name], "rel": rel} \
            if name in doubles else {}
        say(f"{label}_statement", name=name, sf=SF,
            warm_ms_median=statistics.median(runs), warm_ms=runs,
            host_syncs=runner.last_host_syncs, launches_per_run=per_run,
            result=want[name] if len(str(want[name])) < 300 else None,
            equals_oracle=True, card=card, **extra)
    launches = dict(CK.LAUNCHES)
    for k in largest:
        if launches[k] <= 0 or "inputs" not in largest[k]:
            raise AssertionError(f"the {label} phase launched no {k}")
    say(f"{label}_done", statements=len(statements), launches=launches,
        largest={k: {"statement": v["statement"], "rows": v["n"]}
                 for k, v in largest.items()},
        oracle_seconds=round(oracle_s, 3),
        seconds=round(time.perf_counter() - t_phase, 3))
    return {"launches": launches, "want": want, "captured": {
        f"{label}_largest_{v['statement']}": (k, v["inputs"])
        for k, v in largest.items()}}


def oracle_tables(NO, runner, tables=None):
    """The host columns the statement phases' oracles read: ``tables``,
    shared by the phases of one run so that each column is generated
    once, or a new ``NO.Tables``."""
    return tables if tables is not None else NO.Tables(runner.datasource)


def scalars_phase(torch, CK, NO, runner, card: str, tables=None) -> dict:
    """Phase 6b: the ``NO.SCALARS`` statements."""
    return statements_phase(
        torch, CK, runner, card, "scalars", NO.SCALARS,
        lambda: NO.scalars(oracle_tables(NO, runner, tables)),
        NO.SCALARS_DOUBLE)


def strings_dates_phase(torch, CK, NO, runner, card: str,
                        tables=None) -> dict:
    """Phase 6c: the ``NO.STRINGS_DATES`` statements."""
    return statements_phase(
        torch, CK, runner, card, "strings_dates", NO.STRINGS_DATES,
        lambda: NO.strings_dates(oracle_tables(NO, runner, tables)))


AGG_STREAM_SLICE = 131072  # order units a slice: 12 slices of SF1 lineitem
AGG_STREAM_MIN_SLICES = 8


def aggregates_patterns_phase(torch, CK, NO, runner, card: str,
                              tables=None) -> dict:
    """Phase 6d: the ``NO.AGGREGATES_PATTERNS`` statements (DOUBLEs to
    SCALARS_REL: the corr family of int64 arguments and geometric_mean's
    logarithms sum exactly), then the ``AGGREGATES_STREAMED``
    ones through ``run_sql_streaming``, AGG_STREAM_SLICE order units a
    slice, each equal to the oracle, streamed, in at least
    AGG_STREAM_MIN_SLICES slices."""
    out = statements_phase(
        torch, CK, runner, card, "aggregates_patterns",
        NO.AGGREGATES_PATTERNS,
        lambda: NO.aggregates_patterns(oracle_tables(NO, runner, tables)),
        NO.AGGREGATES_PATTERNS_DOUBLE)
    ds = runner.datasource
    before = dict(CK.LAUNCHES)
    for name in NO.AGGREGATES_STREAMED:
        ds.ingest_slices = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = runner.run_sql_streaming(NO.AGGREGATES_PATTERNS[name],
                                         slice_rows=AGG_STREAM_SLICE)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = check_statement("aggregates_streamed", name, table,
                              out["want"], NO.AGGREGATES_PATTERNS_DOUBLE)
        if not runner.last_streamed or ds.ingest_slices < \
                AGG_STREAM_MIN_SLICES:
            raise AssertionError(
                f"aggregates_streamed {name}: streamed "
                f"{runner.last_streamed} in {ds.ingest_slices} slices")
        say("aggregates_streamed", name=name, sf=SF, ms=ms,
            slices=ds.ingest_slices, slice_units=AGG_STREAM_SLICE,
            host_syncs=runner.last_host_syncs, max_rel_err=err,
            equals_oracle=True, card=card)
    out["streamed_launches"] = {k: CK.LAUNCHES[k] - before[k]
                                for k in CK.LAUNCHES}
    return out


def nested_phase(torch, CK, NO, runner, card: str, tables=None) -> dict:
    """Phase 6e: the ``NO.NESTED`` statements."""
    return statements_phase(
        torch, CK, runner, card, "nested", NO.NESTED,
        lambda: NO.nested(oracle_tables(NO, runner, tables)))


# ---------------------------------------------------------------- tpcds

DIST_BROADCAST_ROWS = 300_000  # orders- and lineitem-sized builds partition
DIST_TIMED_RUNS = 3
DIST_DEADLINE_S = 300.0        # the world is killed past it


def distributed_phase(torch, requests: dict, want: dict, card: str) -> dict:
    """Phase 4b: a world of one rank over NCCL (``multihost.launch_world``:
    one rank process of ``presto_tpu_torch.parallel.worker`` on this card,
    killed past ``DIST_DEADLINE_S``) runs phase 4's requests through
    ``DistributedRunner(scale_factor=1.0, broadcast_row_limit=300_000)``:
    one warm-up and 3 timed runs each, every run equal to phase 4's numpy
    oracle; one ``distributed_statement`` line each (warm median, host
    syncs, collectives, bytes exchanged, the joins' build rows, launches
    per run).  The rank resets the kernels' launch counts when it starts
    and reads them at the end: ``masked_sum`` must launch in the BIGINT
    sum's partial and ``sorted_probe`` in every query of ``PROBED``."""
    from presto_tpu_torch.parallel.multihost import launch_world
    t_phase = time.perf_counter()
    runs = 1 + DIST_TIMED_RUNS
    spec = {"sf": SF, "runners": {"default": {
        "broadcast_row_limit": DIST_BROADCAST_ROWS}},
        "jobs": [{"name": n, "sql": q, "runs": runs}
                 for n, q in requests.items()]}
    data = launch_world(1, spec, DIST_DEADLINE_S, device="cuda:0")
    if data["backend"] != "nccl" or not data["device"].startswith("cuda"):
        raise AssertionError(f"the distributed phase ran on {data['device']}"
                             f" over {data['backend']}")
    for rec in data["results"]:
        name = rec["name"]
        if rec["values"] != want[name] or not rec["runs_equal"]:
            raise AssertionError(f"distributed {name}: {rec['values']} != "
                                 f"oracle {want[name]}")
        per_run = {k: v // runs for k, v in rec["launches"].items()}
        say("distributed_statement", name=name, sf=SF, world=data["world"],
            backend=data["backend"],
            warm_ms_median=statistics.median(rec["warm_ms"]),
            warm_ms=rec["warm_ms"], first_run_s=round(rec["first_run_s"], 3),
            host_syncs=rec["host_syncs"], collectives=rec["collectives"],
            bytes_exchanged=rec["bytes_exchanged"],
            build_rows=rec["build_rows"], launches_per_run=per_run,
            rows=rec["rows"], equals_oracle=True, card=card)
        if name == "bigint_sum" and per_run["masked_sum"] <= 0:
            raise AssertionError("the distributed BIGINT sum launched no "
                                 "masked_sum")
        if name in PROBED and per_run["sorted_probe"] <= 0:
            raise AssertionError(f"distributed {name} launched no "
                                 "sorted_probe")
    launches = data["launches"]
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"the distributed phase launched no {k}")
    say("distributed_done", statements=len(data["results"]),
        launches=launches, world=data["world"], backend=data["backend"],
        rank_seconds=round(data["seconds"], 3),
        seconds=round(time.perf_counter() - t_phase, 3))
    return {"launches": launches}


CLUSTER_STATEMENTS = ("q3", "q5", "bigint_sum")


def cluster_phase(torch, requests: dict, want: dict, card: str) -> dict:
    """Phase 4c: ``ClusterSupervisor`` over worlds of one NCCL rank on
    this card supervises ``CLUSTER_STATEMENTS``, one attempt each (the
    module docstring).  A death and its replay need a second card, so
    they are checked on the CPU only; here every attempt must succeed the
    first time.  Returns the ranks' launches, summed."""
    from presto_tpu_torch.parallel.cluster import ClusterSupervisor
    t_phase = time.perf_counter()
    sup = ClusterSupervisor(scale_factor=SF, n_workers=1, min_workers=1,
                            device="cuda:0",
                            attempt_deadline_s=DIST_DEADLINE_S,
                            broadcast_row_limit=DIST_BROADCAST_ROWS)
    launches: dict = {}
    try:
        for name in CLUSTER_STATEMENTS:
            t0 = time.perf_counter()
            table = sup.run_sql(requests[name])
            wall_ms = (time.perf_counter() - t0) * 1e3
            check_statement("cluster", name, table, want)
            world = sup.last_world
            if world["backend"] != "nccl" or \
                    not world["device"].startswith("cuda"):
                raise AssertionError(f"cluster {name} ran on "
                                     f"{world['device']} over "
                                     f"{world['backend']}")
            rec = world["results"][-1]
            for k, v in world["launches"].items():
                launches[k] = launches.get(k, 0) + v
            say("cluster_statement", name=name, sf=SF, wall_ms=wall_ms,
                rows=table.row_count, world=world["world"],
                backend=world["backend"], launches=world["launches"],
                rank_seconds=round(world["seconds"], 3),
                first_run_s=round(rec["first_run_s"], 3),
                host_syncs=rec["host_syncs"],
                collectives=rec["collectives"], attempts=sup.attempts,
                restarts=sup.restarts, equals_oracle=True, card=card)
            if name == "bigint_sum" and world["launches"]["masked_sum"] <= 0:
                raise AssertionError("the supervised BIGINT sum launched "
                                     "no masked_sum")
            if name in PROBED and world["launches"]["sorted_probe"] <= 0:
                raise AssertionError(f"supervised {name} launched no "
                                     "sorted_probe")
    finally:
        sup.shutdown()
    if sup.attempts != len(CLUSTER_STATEMENTS) or sup.restarts != 0:
        raise AssertionError(f"cluster: {sup.attempts} attempts and "
                             f"{sup.restarts} restarts for "
                             f"{len(CLUSTER_STATEMENTS)} statements")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"the cluster phase launched no {k}")
    say("cluster_done", statements=len(CLUSTER_STATEMENTS),
        attempts=sup.attempts, restarts=sup.restarts,
        attempt_worlds=sup.attempt_worlds, launches=launches,
        seconds=round(time.perf_counter() - t_phase, 3), card=card)
    return {"launches": launches}


def tpcds_load(conn, runner) -> dict:
    """Every column of every TPC-DS table generated on the host and
    uploaded to the card (the scan cache), timed."""
    from presto_tpu_torch.tpcds import schema as DS
    from presto_tpu_torch.utils.memory import col_bytes
    t0 = time.perf_counter()
    rows, nbytes = {}, 0
    for table, cols in DS.TABLE_SCHEMAS.items():
        chunk = runner.datasource.scan(table, [c for c, _ in cols])
        rows[table] = chunk.n_rows
        nbytes += sum(col_bytes(c) for c in chunk.cols.values())
    return dict(sf=TPCDS_SF, seconds=round(time.perf_counter() - t0, 3),
                tables=len(rows), rows=rows, device_bytes=nbytes,
                values=sum(rows[t] * len(c)
                           for t, c in DS.TABLE_SCHEMAS.items()))


LARGE_BUILD = 1 << 16  # valid keys of a whole dimension table's build


def tpcds_probe_capture(torch, CK, runner, queries) -> tuple:
    """One more run of each query with ``CK.set_probe_recorder`` on: the
    largest ``sorted_probe`` launch of each (probes, valid keys), and,
    copied as the main path gave them, the inputs of the launch with the
    most probes and of the one with the most probes into a build of at
    least LARGE_BUILD valid keys."""
    best = {"largest": {}, "largest_into_large_build": {}}
    per_query = {}
    current = [None]

    def record(keys, probes, n_valid):
        p, nv = probes.shape[0], int(n_valid)
        q = current[0]
        if p > per_query.get(q, (-1, 0))[0]:
            per_query[q] = (p, nv)
        for name, ok in (("largest", True),
                         ("largest_into_large_build", nv >= LARGE_BUILD)):
            if ok and p > best[name].get("p", -1):
                best[name].update(p=p, q=q, inputs=(
                    keys.clone(), probes.clone(),
                    torch.tensor(nv, device=keys.device)))

    CK.set_probe_recorder(record)
    try:
        for q, sql in queries.items():
            current[0] = q
            runner.run_sql(sql)
    finally:
        CK.set_probe_recorder(None)
    return best, per_query


def tpcds_phase(torch, CK) -> dict:
    """The TPC-DS main path at SF1 and its two checks (see the module
    docstring, phase 7).  Returns the kernels' launch counts over the main
    path and the measured shapes of ``sorted_probe``'s largest launches."""
    import concurrent.futures
    import sqlite_tpcds_oracle as SO
    from presto_tpu_torch.connector import tpcds_connector
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.tpcds.queries import QUERIES, RUNS

    conn = tpcds_connector(TPCDS_SF)  # one host copy for card and CPU
    card = LocalRunner(scale_factor=0.01)
    card.datasource.register(conn)
    say("tpcds_load", **tpcds_load(conn, card))

    # the main path: counts reset just before, read just after
    CK.reset_launches()
    results, per_query = {}, {}
    for q in RUNS:
        before = dict(CK.LAUNCHES)
        t0 = time.perf_counter()
        results[q] = [card.run_sql(QUERIES[q])]   # warm-up
        first_s = time.perf_counter() - t0
        runs = []
        for _ in range(TPCDS_TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[q].append(card.run_sql(QUERIES[q]))
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        per_query[q] = {k: (CK.LAUNCHES[k] - before[k]) //
                        (1 + TPCDS_TIMED_RUNS) for k in CK.LAUNCHES}
        say("tpcds_query", q=q, sf=TPCDS_SF,
            warm_ms_median=statistics.median(runs), warm_ms=runs,
            first_run_s=round(first_s, 3), host_syncs=card.last_host_syncs,
            launches_per_run=per_query[q],
            rows=results[q][0].row_count)
    launches = dict(CK.LAUNCHES)
    unprobed = [q for q in RUNS if per_query[q]["sorted_probe"] <= 0]
    say("tpcds_launch_check", unprobed=unprobed,
        allowed=list(TPCDS_UNPROBED), launches=launches,
        masked_sum_in=[q for q in RUNS if per_query[q]["masked_sum"] > 0])
    missing = sorted(set(unprobed) - set(TPCDS_UNPROBED))
    if missing:
        raise AssertionError(f"TPC-DS queries {missing} did not launch "
                             "sorted_probe")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} never launched on the TPC-DS path")

    best, largest = tpcds_probe_capture(
        torch, CK, card, {q: QUERIES[q] for q in RUNS})
    say("tpcds_probe_shapes", largest_per_query={
        q: {"probes": p, "n_valid": nv} for q, (p, nv) in largest.items()})
    if any("inputs" not in b for b in best.values()):
        raise AssertionError(f"no TPC-DS sorted_probe launch for "
                             f"{[n for n, b in best.items() if not b]}")

    # the SF0.02 card results, held to SQLite in a thread while the CPU
    # run of SF1 is the check of the main thread
    small = LocalRunner(scale_factor=0.01)
    small.datasource.register(tpcds_connector(TPCDS_CHECK_SF))
    small_results = {q: small.run_sql(QUERIES[q]) for q in RUNS}
    torch.cuda.synchronize()

    def sqlite_check() -> dict:
        t0 = time.perf_counter()
        db = SO.build_db(small.datasource,
                         [SO.sqlite_sql(q, QUERIES[q]) for q in RUNS])
        load_s = time.perf_counter() - t0
        got, failed = {}, {}
        for q in RUNS:
            try:
                got[q] = SO.check(db, q, QUERIES[q], small_results[q])
            except AssertionError as e:  # collected, then raised below
                failed[q] = str(e)[:300]
        if failed:
            raise AssertionError(f"TPC-DS SF{TPCDS_CHECK_SF} on the card "
                                 f"against SQLite: {failed}")
        return dict(sf=TPCDS_CHECK_SF, load_s=round(load_s, 3),
                    seconds=round(time.perf_counter() - t0, 3),
                    queries=len(got), equal=True,
                    rows={q: r["rows"] for q, r in got.items()},
                    tie_at_limit=[q for q, r in got.items()
                                  if r["tie_at_limit"]])

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        sqlite_job = pool.submit(sqlite_check)
        cpu = LocalRunner(scale_factor=0.01, device="cpu")
        cpu.datasource.register(conn)
        t0 = time.perf_counter()
        for q in RUNS:
            want = cpu.run_sql(QUERIES[q])
            for i, got in enumerate(results[q]):
                SO.same_table(got, want, DOUBLE_REL,
                              f"TPC-DS q{q} SF1 run {i} vs the CPU")
        say("tpcds_cpu_check", sf=TPCDS_SF, queries=len(RUNS),
            runs_each=1 + TPCDS_TIMED_RUNS, equal=True,
            seconds=round(time.perf_counter() - t0, 3))
        say("tpcds_sqlite_check", **sqlite_job.result())

    return {"launches": launches, "captured": {
        f"tpcds_{name}_q{b['q']}": ("sorted_probe", b["inputs"])
        for name, b in best.items()}}


MEASURE_ARG = "--measure-probes"


def measure_apart(torch, captured: dict) -> list:
    """``measure_masked_sum``, ``measure_sorted_probe`` or
    ``measure_seg_reduce`` at each captured launch (name -> kernel, its
    inputs), in a fresh process of this script started with
    ``MEASURE_ARG`` and a file of the inputs under build/.
    After the TPC-DS main path this process's profiler records only part
    of a window's device activities, and that stays so after
    ``torch.cuda.empty_cache()``; a fresh process records them whole.
    Each shape comes back with its ``kernel``."""
    path = os.path.join(ROOT, "build", "probe_inputs.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({name: (kernel, [x.cpu() for x in inputs])
                for name, (kernel, inputs) in captured.items()}, path)
    try:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              MEASURE_ARG, path], capture_output=True,
                             text=True, timeout=600)
    finally:
        os.remove(path)
    for ln in out.stdout.splitlines():
        if ln.startswith("[profiler] "):
            print(ln, flush=True)
    if out.returncode:
        raise AssertionError(f"the measuring process exited "
                             f"{out.returncode}: {out.stderr[-4000:]}")
    shapes = [json.loads(ln[len("[measure] "):])
              for ln in out.stdout.splitlines()
              if ln.startswith("[measure] ")]
    if len(shapes) != len(captured):
        raise AssertionError(f"the measuring process reported "
                             f"{len(shapes)} of {len(captured)} shapes")
    return shapes


def measure_probes(path: str) -> int:
    """The child of ``measure_apart``: one ``measure`` line per launch
    saved in ``path``, each with its kernel and ``shape`` name."""
    import torch
    from presto_tpu_torch.ops import cuda_kernels as CK
    CK.build()
    for name, (kernel, inputs) in torch.load(path).items():
        args = [x.cuda() for x in inputs]
        if kernel == "sorted_probe":
            shape = measure_sorted_probe(torch, CK, name, *args)
        elif kernel == "seg_reduce":
            shape = measure_seg_reduce(torch, CK, name, *args)
        else:
            shape = measure_masked_sum(torch, CK, *args, name=name)
        print("[measure] " + json.dumps(dict(kernel=kernel, **shape)),
              flush=True)
    return 0


# ---------------------------------------------------------------- server

SERVER_CLIENTS = 4         # client threads of the concurrent pass
SERVER_TIMED_RUNS = 3      # timed runs of each request by one client
PAGED_DAY = "1995-03-15"
PAGED_SQL = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
             f"where l_shipdate = date '{PAGED_DAY}' order by 1, 2")
LI95_CTAS = ("create table li95 as select l_orderkey, l_partkey, l_quantity, "
             "l_extendedprice, l_discount, l_shipdate from lineitem "
             "where l_shipdate >= date '1995-01-01'")
LI95_INSERT = ("insert into li95 select l_orderkey, l_partkey, l_quantity, "
               "l_extendedprice, l_discount, l_shipdate from lineitem "
               "where l_shipdate < date '1995-01-01'")
LI95_AGG = ("select count(*) c, sum(l_orderkey) s, sum(l_partkey) p, "
            "sum(l_quantity) q, sum(l_extendedprice) e, sum(l_discount) d, "
            "min(l_shipdate) lo, max(l_shipdate) hi from li95")
LI95_SUM = "select sum(l_orderkey) s, count(*) c from li95"
LI95_JOIN = ("select o_orderpriority, count(*) c, sum(l_quantity) q "
             "from li95, orders where l_orderkey = o_orderkey "
             "group by o_orderpriority order by o_orderpriority")


def _post(url: str, sql: str) -> dict:
    """The last response body of one statement (POST, then nextUri)."""
    import urllib.request
    req = urllib.request.Request(f"{url}/v1/statement", data=sql.encode(),
                                 method="POST")
    with urllib.request.urlopen(req) as r:
        body = json.loads(r.read())
    while "nextUri" in body:
        with urllib.request.urlopen(body["nextUri"]) as r:
            body = json.loads(r.read())
    return body


def _get(url: str):
    import urllib.request
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def server_phase(torch, CK, NO, requests: dict, want: dict,
                 card: str) -> dict:
    """The client edge at SF1: a ``StatementServer`` over
    ``connect(schema="sf1")`` on the card, admission through one resource
    group of one running statement; four clients at once, then one, send
    every request over HTTP; a statement of three pages; CTAS, INSERT,
    UPDATE, DELETE, SHOW and DROP of a memory table of millions of rows and
    a rolled-back transaction, each held to numpy; EXPLAIN ANALYZE of Q3;
    two errors.  Launch counts are reset before the first statement and
    read after the last (the run_sql and cursor runs timed beside the
    HTTP ones are subtracted).  Returns the counts and the inputs of the
    largest launch of each kernel in the ``li95`` sum and join
    (``server_writes``), which only this phase forms."""
    import concurrent.futures
    from presto_tpu_torch.client.api import connect
    from presto_tpu_torch.client.server import (PAGE_ROWS, HttpClient,
                                                StatementServer)
    from presto_tpu_torch.parallel.resource_groups import (
        ResourceGroup, ResourceGroupManager)
    from presto_tpu_torch.tpch.queries import QUERIES
    from presto_tpu_torch.tpch.schema import TABLE_SCHEMAS

    t_phase = time.perf_counter()
    conn = connect(schema="sf1")
    runner, ds = conn._runner, conn._runner.datasource
    # the warm-up, through run_sql: ingest and plans; the SQL type of each
    # request's columns, with which the numpy results are rendered
    t0 = time.perf_counter()
    types = {name: [str(c.dtype) for c in runner.run_sql(sql)
                    .columns.values()] for name, sql in requests.items()}
    warm_up_s = time.perf_counter() - t0
    wire = {name: NO.wire_rows(want[name], types[name]) for name in requests}

    def check(label, got, names, rows, col_types=None):
        cols, data = got
        if [c["name"] for c in cols] != list(names) or data != rows or (
                col_types is not None
                and [c["type"] for c in cols] != list(col_types)):
            raise AssertionError(f"server {label}: {cols} {data[:5]} != "
                                 f"oracle {list(names)} {rows[:5]}")

    groups = ResourceGroupManager([ResourceGroup(
        "global", hard_concurrency_limit=1, max_queued=64)],
        [("*", "global")])
    srv = StatementServer(conn, port=0, resource_groups=groups)
    aside = {k: 0 for k in CK.LAUNCHES}  # launches of the timed-beside runs

    def beside(fn):
        before = dict(CK.LAUNCHES)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for k in aside:
            aside[k] += CK.LAUNCHES[k] - before[k]
        return ms

    try:
        # the main path: counts reset just before, read just after
        CK.reset_launches()

        def client(k):
            cli = HttpClient(srv.url, user=f"client{k}")
            return {name: cli.execute(sql) for name, sql in requests.items()}

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVER_CLIENTS) as pool:
            passes = list(pool.map(client, range(SERVER_CLIENTS)))
        concurrent_s = time.perf_counter() - t0
        for k, got in enumerate(passes):
            for name in requests:
                check(f"client {k} {name}", got[name], want[name],
                      wire[name], types[name])
        admitted = _get(f"{srv.url}/v1/resourceGroup")[0]["admitted"]
        states = [q["state"] for q in _get(f"{srv.url}/v1/query")]
        if admitted != SERVER_CLIENTS * len(requests) or \
                states != ["FINISHED"] * admitted:
            raise AssertionError(f"server: {admitted} admitted, states "
                                 f"{sorted(set(states))}")
        say("server_concurrent", clients=SERVER_CLIENTS,
            statements=admitted, all_finished=True, equal_oracle=True,
            seconds=round(concurrent_s, 3), warm_up_s=round(warm_up_s, 3),
            card=card)

        # one client: HTTP beside the DB-API cursor and run_sql
        cli = HttpClient(srv.url)
        for name, sql in requests.items():
            times = {"http": [], "cursor": [], "run_sql": []}
            for _ in range(SERVER_TIMED_RUNS):
                t0 = time.perf_counter()
                got = cli.execute(sql)
                times["http"].append((time.perf_counter() - t0) * 1e3)
                check(f"timed {name}", got, want[name], wire[name])
                times["cursor"].append(beside(
                    lambda: conn.execute(sql).fetchall()))
                times["run_sql"].append(beside(lambda: runner.run_sql(sql)))
            med = {k: statistics.median(v) for k, v in times.items()}
            say("server_request", name=name, sf=SF,
                http_ms_median=med["http"], cursor_ms_median=med["cursor"],
                run_sql_ms_median=med["run_sql"],
                protocol_ms=med["http"] - med["run_sql"],
                http_ms=times["http"], run_sql_ms=times["run_sql"],
                rows=len(wire[name]), card=card)

        # a statement of three pages and more
        t = NO.Tables(ds)
        paged = NO.shipped_on(t, PAGED_DAY)
        schema = dict(TABLE_SCHEMAS["lineitem"])
        paged_wire = NO.wire_rows(paged, [str(schema[c]) for c in paged])
        paged_ms = []  # the first run uploads l_linenumber, the second
        for _ in range(2):  # is warm
            t0 = time.perf_counter()
            got = cli.execute(PAGED_SQL)
            paged_ms.append((time.perf_counter() - t0) * 1e3)
            check("paged", got, paged, paged_wire)
        if len(got[1]) <= 2 * PAGE_ROWS:
            raise AssertionError(f"paged: {len(got[1])} rows, under three "
                                 "pages")
        say("server_paged", rows=len(got[1]),
            pages=-(-len(got[1]) // PAGE_ROWS), equal_oracle=True,
            first_ms=paged_ms[0], warm_ms=paged_ms[1], card=card)

        writes = server_writes(torch, CK, NO, conn, cli, t, card)

        # EXPLAIN ANALYZE of Q3: every operator with rows and ms, the
        # root's rows Q3's, the self times within the root's wall
        _, rows = cli.execute("explain analyze " + QUERIES[3])
        lines = [r[0] for r in rows]
        nodes = [ln for ln in lines if ln.lstrip().startswith("- ")]
        stats = [re.search(r"\{rows: (\d+), wall: ([\d.]+)ms", ln)
                 for ln in nodes]
        wall = [float(re.match(r"analyze: ([\d.]+)ms", ln).group(1))
                for ln in lines if ln.startswith("analyze: ")]
        self_ms = sum(float(m.group(2)) for m in stats if m)
        if not nodes or not all(stats) or not wall or \
                int(stats[0].group(1)) != len(want["q3"]["l_orderkey"]) or \
                self_ms > wall[0] + 5e-4 * len(nodes):
            raise AssertionError("explain analyze q3:\n" + "\n".join(lines))
        say("server_explain_analyze", query="q3", plan=lines,
            operators=len(nodes), self_ms_sum=self_ms, wall_ms=wall[0],
            card=card)

        # errors come back through the protocol; the server answers after
        errors = {sql: _post(srv.url, sql)["error"]["errorName"]
                  for sql in ("select * from no_such_table_xyz",
                              "selec 1 from nation")}
        if list(errors.values()) != ["TABLE_NOT_FOUND", "SYNTAX_ERROR"] or \
                cli.execute("select count(*) c from nation")[1] != [[25]]:
            raise AssertionError(f"server errors: {errors}")
        say("server_errors", errors=errors, answers_after=True)
        launches = {k: CK.LAUNCHES[k] - aside[k] for k in CK.LAUNCHES}
    finally:
        srv.close()
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} never launched on the server path")
    say("server_launch_check", launches=launches,
        launches_beside=aside, **writes["launches"])
    say("server_done", seconds=round(time.perf_counter() - t_phase, 3))
    return {"launches": launches, "captured": writes["captured"]}


def server_writes(torch, CK, NO, conn, cli, t, card: str) -> dict:
    """CTAS, the sum (masked_sum) and the join (sorted_probe) over it,
    INSERT, UPDATE, DELETE, SHOW TABLES / STATS, a rolled-back
    transaction and DROP of ``li95``, over HTTP at SF1, each held to the
    numpy copy (``NO.Li95``) and the stored snapshot to its arrays."""
    import numpy as np
    from presto_tpu_torch.tpch.schema import TABLE_SCHEMAS
    ds = conn._runner.datasource
    li = NO.Li95(t)
    agg_names = ("c", "s", "p", "q", "e", "d", "lo", "hi")

    def stored(label):
        snap = ds.memory["li95"]
        for c, v in li.cols.items():
            if not np.array_equal(np.asarray(snap.columns[c].values), v):
                raise AssertionError(f"li95 after {label}: column {c} "
                                     "differs from the numpy copy")
        got = cli.execute(LI95_AGG)
        want_row = NO.wire_rows(dict(zip(agg_names, ([x] for x in
                                                     li.agg_row()))),
                                NO.LI95_AGG_TYPES)
        if got[1] != want_row:
            raise AssertionError(f"li95 after {label}: {got[1]} != "
                                 f"{want_row}")

    def timed(sql, want_rows, label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cli.execute(sql)[1]
        s = time.perf_counter() - t0
        if got != [[want_rows]]:
            raise AssertionError(f"{label}: {got} rows != {want_rows}")
        stored(label)
        return s

    captured = {}

    def launched(sql, kernel, name):
        """Runs ``sql`` over HTTP; the inputs of ``kernel``'s launch with
        the most rows (values summed, or probes) are kept as
        ``captured[name]``, copied as the path gave them."""
        best = {}
        setter = {"masked_sum": CK.set_sum_recorder,
                  "sorted_probe": CK.set_probe_recorder}[kernel]
        before = CK.LAUNCHES[kernel]
        setter(record_largest(torch, kernel, best))
        try:
            got = cli.execute(sql)
        finally:
            setter(None)
        n = CK.LAUNCHES[kernel] - before
        if n <= 0:
            raise AssertionError(f"{sql!r} launched no {kernel}")
        captured[name] = (kernel, best["inputs"])
        return got, n

    pool_before = ds.pool.used
    out = {"ctas_s": timed(LI95_CTAS, li.n, "ctas"), "ctas_rows": li.n}
    got, out["sum_masked_sum_launches"] = launched(
        LI95_SUM, "masked_sum", "server_li95_sum")
    if got[1] != [[li.agg_row()[1], li.n]]:
        raise AssertionError(f"li95 sum: {got[1]}")
    got, out["join_sorted_probe_launches"] = launched(
        LI95_JOIN, "sorted_probe", "server_li95_join_orders")
    by = li.by_priority()
    if got[1] != NO.wire_rows(by, ("varchar", "bigint", "decimal(15,2)")):
        raise AssertionError(f"li95 join: {got[1]} != {by}")
    n = li.insert_rest()
    out.update(insert_s=timed(LI95_INSERT, n, "insert"), insert_rows=n)
    full = {c: t.v("lineitem", c) for c in NO.LI95}
    if li.n != full["l_orderkey"].shape[0]:
        raise AssertionError("li95 after insert is not all of lineitem")
    n = li.update_discount(50)
    out.update(update_s=timed(
        "update li95 set l_discount = 0 where l_quantity >= 50", n,
        "update"), update_rows=n)
    n = li.delete_shipped_before("1993-01-01")
    out.update(delete_s=timed(
        "delete from li95 where l_shipdate < date '1993-01-01'", n,
        "delete"), delete_rows=n)
    tables = [r[0] for r in cli.execute("show tables")[1]]
    if "li95" not in tables or not set(TABLE_SCHEMAS) <= set(tables):
        raise AssertionError(f"show tables: {tables}")
    t0 = time.perf_counter()
    got = cli.execute("show stats for li95")[1]
    out["show_stats_s"] = time.perf_counter() - t0
    if got != li.stats():
        raise AssertionError(f"show stats: {got} != {li.stats()}")
    # a transaction through the DB-API, rolled back: the sums come back
    pre = cli.execute(LI95_AGG)[1]
    conn.begin()
    conn.execute("update li95 set l_quantity = 0, l_discount = 0")
    during = cli.execute(LI95_AGG)[1]
    conn.rollback()
    after = cli.execute(LI95_AGG)[1]
    if during[0][3:6] != ["0.00", pre[0][4], "0.00"] or after != pre:
        raise AssertionError(f"rollback: {pre} -> {during} -> {after}")
    stored("rollback")
    cli.execute("drop table li95")
    if ds.pool.used != pool_before or "li95" in ds.memory:
        raise AssertionError(f"drop: pool used {ds.pool.used} != "
                             f"{pool_before} before the CTAS")
    launches = {k: out.pop(k) for k in list(out) if k.endswith("launches")}
    say("server_writes", sf=SF, pool_used_before_ctas=pool_before,
        pool_used_after_drop=ds.pool.used, rollback_restored=True,
        show_stats_equal=True, card=card, **out)
    return {"launches": launches, "captured": captured, **out}


# ---------------------------------------------------------------- tiers

TIERS_HEADROOM = 64 << 20  # the budget above the pool's used bytes
TIERS_TIMED_RUNS = 3
TIERS_SORT = ("select o_orderkey, o_totalprice from orders "
              "order by o_totalprice desc, o_orderkey")
# join requests that must run a partitioned join under the budget
TIERS_MIN_JOINS = 5
STREAM_SF = 10.0
STREAM_SLICE = 1 << 20     # order units per slice: 15 slices of lineitem
STREAM_SLICES = 15
PRUNED_KEYS = (1_000_000, 2_000_000)
PRUNED_DECIMAL = "59999000.5"  # within the last slice of SF10's orders
STREAMED = {
    "bigint_sum": "select sum(l_orderkey) s, count(*) c from lineitem",
    "approx_distinct": "select l_returnflag, approx_distinct(l_partkey) a "
                       "from lineitem group by l_returnflag "
                       "order by l_returnflag",
    "high_ndv": "select l_orderkey, sum(l_quantity) q, count(*) c "
                "from lineitem group by l_orderkey order by l_orderkey",
    "pruned": "select o_orderpriority, count(*) c, sum(o_totalprice) s "
              "from orders where o_orderkey between "
              f"{PRUNED_KEYS[0]} and {PRUNED_KEYS[1]} "
              "group by o_orderpriority order by o_orderpriority",
    # a decimal bound on the BIGINT key: pruning rounds it up to a key
    "pruned_decimal": "select count(*) c, sum(o_custkey) s from orders "
                      f"where o_orderkey >= {PRUNED_DECIMAL}"}


def peak_start(torch) -> int:
    """Fence the card, restart its peak statistics; the bytes allocated
    now (a run's peak is ``max_memory_allocated()`` less these)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def scan_columns(plan, table: str) -> set:
    """The columns every scan of ``table`` in ``plan`` reads."""
    from presto_tpu_torch.exec.plan import PhysScan
    out, stack = set(), [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, PhysScan) and node.table == table:
            out |= set(node.columns)
        stack.extend(node.children())
    return out


def _same_arrays(label: str, got, want: dict) -> None:
    for c, w in want.items():
        g = np.asarray(got.columns[c].values)
        if g.dtype == object:
            g = g.astype(np.int64)
        if g.shape != np.shape(w) or not np.array_equal(g, w):
            raise AssertionError(f"{label}: column {c} differs from numpy")


def tiers_phase(torch, CK, NO, runner, requests: dict, want: dict,
                free: dict, card: str) -> dict:
    """Phase 9 (see the module docstring): the budgeted SF1 requests and
    the streamed SF10 statements.  Returns the launches of each path and
    the inputs of the largest ``sorted_probe`` launch inside a
    partitioned join."""
    t_phase = time.perf_counter()
    budgeted = tiers_budgeted(torch, CK, NO, runner, requests, want, free,
                              card)
    streamed = tiers_streamed(torch, CK, card)
    say("tiers_done", seconds=round(time.perf_counter() - t_phase, 3))
    return {"launches": {"tiers": budgeted["launches"],
                         "streamed": streamed},
            "captured": budgeted["captured"]}


def tiers_budgeted(torch, CK, NO, runner, requests: dict, want: dict,
                   free: dict, card: str) -> dict:
    """Each request at SF1 with the pool's budget at its ``used`` bytes
    plus TIERS_HEADROOM: the columns stay cached, a large operator's
    working set does not fit, so it runs partitioned.  Each run equal to
    the oracle; the ORDER BY of every order equal to ``np.lexsort``."""
    from presto_tpu_torch.exec import physical as PH
    pool = runner.datasource.pool
    default = pool.budget
    t = NO.Tables(runner.datasource)
    t.preload("orders", ("o_orderkey", "o_totalprice"))
    sort_want = NO.orders_by_price(t)
    best, inside, joined, current = {}, [0], {}, [None]
    join_partitioned = PH._exec_join_partitioned

    def partitioned_join(*args):
        joined[current[0]] = joined.get(current[0], 0) + 1
        inside[0] += 1
        try:
            return join_partitioned(*args)
        finally:
            inside[0] -= 1

    def record(keys, probes, n_valid):
        if inside[0] and int(n_valid) > 0 \
                and probes.shape[0] > best.get("p", -1):
            best.update(p=probes.shape[0], q=current[0], nv=int(n_valid),
                        inputs=(keys.clone(), probes.clone(),
                                torch.tensor(int(n_valid),
                                             device=keys.device)))

    def check(name, table):
        if name == "order_by":
            _same_arrays("tiers order_by", table, sort_want)
        elif {c: col.to_pylist() for c, col in
              table.columns.items()} != want[name]:
            raise AssertionError(f"tiers {name}: differs from the oracle")

    PH._exec_join_partitioned = partitioned_join
    launches = {k: 0 for k in CK.LAUNCHES}
    spilled = {}
    try:
        for name, sql in {**requests, "order_by": TIERS_SORT}.items():
            current[0] = name
            pool.budget = default
            runner.run_sql(sql)  # warm: every column it scans cached
            pool.budget = pool.used + TIERS_HEADROOM
            # the main path of this phase: the runs under the budget
            before = dict(CK.LAUNCHES)
            CK.set_probe_recorder(record)
            try:
                check(name, runner.run_sql(sql))  # warm-up
            finally:
                CK.set_probe_recorder(None)
            runs = []
            for _ in range(TIERS_TIMED_RUNS):
                base = peak_start(torch)
                t0 = time.perf_counter()
                table = runner.run_sql(sql)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
                peak = torch.cuda.max_memory_allocated() - base
                check(name, table)
            per_run = {k: (CK.LAUNCHES[k] - before[k])
                       // (1 + TIERS_TIMED_RUNS) for k in CK.LAUNCHES}
            for k in launches:
                launches[k] += CK.LAUNCHES[k] - before[k]
            spilled[name] = runner.last_spill_partitions
            say("tiers_request", name=name, sf=SF, budget=pool.budget,
                pool_used=pool.used, warm_ms_median=statistics.median(runs),
                warm_ms=runs, spill_partitions=runner.last_spill_partitions,
                host_syncs=runner.last_host_syncs, peak_bytes=peak,
                free_warm_ms=free.get(name, {}).get("warm_ms"),
                free_peak_bytes=free.get(name, {}).get("peak_bytes"),
                launches_per_run=per_run, equals_oracle=True, card=card)
    finally:
        PH._exec_join_partitioned = join_partitioned
        pool.budget = default
    joins = sorted(joined)
    say("tiers_check", spilled={q: n for q, n in spilled.items() if n},
        partitioned_joins=joins, launches=launches,
        largest_partitioned_probe={k: best.get(k) for k in ("q", "p", "nv")})
    if spilled["q1"] <= 0 or spilled["order_by"] <= 0:
        raise AssertionError("Q1's aggregation or the ORDER BY did not run "
                             "partitioned under the budget")
    if len(joins) < TIERS_MIN_JOINS:
        raise AssertionError(f"only {joins} ran partitioned joins")
    if launches["sorted_probe"] <= 0 or "inputs" not in best:
        raise AssertionError("no sorted_probe launch inside a partitioned "
                             "join")
    return {"launches": launches, "captured": {
        f"tiers_partitioned_join_{best['q']}": ("sorted_probe",
                                                best["inputs"])}}


STREAM_ORACLE_ARG = "--stream-oracle"


def stream_oracle(path: str, sf: str, lo: str, hi: str) -> int:
    """The child of ``tiers_streamed``: the numpy answers of its
    statements over the generated host tables at scale ``sf``
    (``np_tpch_oracle``; the pruned query's keys in [lo, hi]), pickled to
    ``path``.  It runs on the host beside the streamed runs, which
    generate the same tables slice by slice."""
    import pickle
    import np_tpch_oracle as NO
    from presto_tpu_torch.exec.datasource import DataSource
    t = NO.Tables(DataSource(float(sf), "cpu"))
    t.preload("lineitem", ("l_orderkey", "l_partkey", "l_quantity",
                           "l_extendedprice", "l_discount", "l_tax",
                           "l_returnflag", "l_linestatus", "l_shipdate"))
    t.preload("orders", ("o_orderkey", "o_orderpriority", "o_totalprice",
                         "o_custkey"))
    want = {"q1": NO.q1(t), "q6": NO.q6(t),
            "bigint_sum": NO.lineitem_sum(t),
            "approx_distinct": NO.approx_distinct_partkey(t),
            "high_ndv": NO.orderkey_groups(t),
            "pruned": NO.orders_in_keys(t, int(lo), int(hi)),
            "pruned_decimal": NO.orders_from_key(
                t, math.floor(float(PRUNED_DECIMAL)) + 1)}
    with open(path, "wb") as f:
        pickle.dump(want, f)
    return 0


def tiers_streamed(torch, CK, card: str) -> dict:
    """``run_sql_streaming`` at SF10, ``STREAM_SLICE`` order units a
    slice: TPC-H Q1 and Q6 and the ``STREAMED`` statements, each against
    numpy over the same generated host tables (computed by a child
    process of this script while the statements run, ``stream_oracle``);
    nothing of the streamed table cached; the streamed Q1's peak under
    half the bytes of the resident path's scan of the same columns, which
    is run once (bounded ingest of ``STREAM_SLICE`` units) and must agree
    too.  Returns the launches of the streamed statements."""
    import pickle
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.tpch.queries import QUERIES
    from presto_tpu_torch.utils.memory import col_bytes
    path = os.path.join(ROOT, "build", "stream_oracle.pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t_oracle = time.perf_counter()
    child = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              STREAM_ORACLE_ARG, path, str(STREAM_SF),
                              *map(str, PRUNED_KEYS)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        r10 = LocalRunner(scale_factor=STREAM_SF)
        ds = r10.datasource
        statements = {"q1": QUERIES[1], "q6": QUERIES[6], **STREAMED}
        launches = {k: 0 for k in CK.LAUNCHES}
        runs = {}
        for name, sql in statements.items():
            ds.ingest_slices = 0
            before = dict(CK.LAUNCHES)
            base = peak_start(torch)
            t0 = time.perf_counter()
            got = r10.run_sql_streaming(sql, slice_rows=STREAM_SLICE)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            per = {k: CK.LAUNCHES[k] - before[k] for k in CK.LAUNCHES}
            for k in launches:
                launches[k] += per[k]
            runs[name] = dict(
                got=got, ms=ms, launches=per, slices=ds.ingest_slices,
                peak=torch.cuda.max_memory_allocated() - base,
                syncs=r10.last_host_syncs, streamed=r10.last_streamed,
                cached=sorted({tb for tb, _ in ds._cols}))
        del r10, ds
        torch.cuda.empty_cache()
        # the resident path of Q1 at SF10: bounded ingest, then a warm run
        res = LocalRunner(scale_factor=STREAM_SF,
                          ingest_slice_rows=STREAM_SLICE)
        t0 = time.perf_counter()
        first = res.run_sql(QUERIES[1])
        first_s = time.perf_counter() - t0
        ingest = res.datasource.ingest_slices
        # the bytes of the columns Q1 scans (the page source may return
        # more with them, and the cache keeps those too)
        q1_cols = scan_columns(res.plan_sql(QUERIES[1]), "lineitem")
        scan_bytes = sum(col_bytes(c) for (tb, name), c in
                         res.datasource._cols.items()
                         if tb == "lineitem" and name in q1_cols)
        base = peak_start(torch)
        t0 = time.perf_counter()
        warm = res.run_sql(QUERIES[1])
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        res_peak = torch.cuda.max_memory_allocated() - base
        del res
        torch.cuda.empty_cache()
        _, err = child.communicate(timeout=900)
        if child.returncode:
            raise AssertionError(f"the oracle process exited "
                                 f"{child.returncode}: {err[-4000:]}")
        with open(path, "rb") as f:
            want = pickle.load(f)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        if os.path.exists(path):
            os.remove(path)
    say("tiers_oracle", sf=STREAM_SF, process=True,
        seconds_until_read=round(time.perf_counter() - t_oracle, 3))
    for name, run in runs.items():
        got = run["got"]
        if name == "high_ndv":
            _same_arrays("streamed high_ndv", got, want[name])
        elif {c: col.to_pylist() for c, col in
              got.columns.items()} != want[name]:
            raise AssertionError(f"streamed {name}: {got.to_pydict()} != "
                                 f"{want[name]}")
        if not run["streamed"] or run["cached"]:
            raise AssertionError(f"streamed {name}: streamed "
                                 f"{run['streamed']}, cached {run['cached']}")
        if not name.startswith("pruned") and run["slices"] != STREAM_SLICES:
            raise AssertionError(f"streamed {name}: {run['slices']} slices")
        if name.startswith("pruned") and run["slices"] > 3:
            raise AssertionError(f"{name}: {run['slices']} slices read")
        if name == "bigint_sum" and run["launches"]["masked_sum"] <= 0:
            raise AssertionError("the streamed BIGINT sum launched no "
                                 "masked_sum")
        say("tiers_streamed", name=name, sf=STREAM_SF,
            slice_units=STREAM_SLICE, slices=run["slices"], ms=run["ms"],
            peak_bytes=run["peak"], host_syncs=run["syncs"],
            launches=run["launches"], rows=got.row_count,
            result=got.to_pydict() if got.row_count <= 5 else None,
            equals_oracle=True, card=card)
    for label, table in (("first", first), ("warm", warm)):
        if {c: col.to_pylist() for c, col in
                table.columns.items()} != want["q1"]:
            raise AssertionError(f"resident Q1 ({label}) differs")
    q1_peak = runs["q1"]["peak"]
    say("tiers_resident_q1", sf=STREAM_SF, ingest_slices=ingest,
        scanned_columns=sorted(q1_cols),
        first_run_s=round(first_s, 3), warm_ms=warm_ms,
        streamed_ms=runs["q1"]["ms"], scan_bytes=scan_bytes,
        peak_bytes=res_peak, streamed_peak_bytes=q1_peak,
        streamed_peak_share=q1_peak / scan_bytes, equals_oracle=True,
        card=card)
    if ingest != STREAM_SLICES:
        raise AssertionError(f"resident ingest: {ingest} slices")
    if q1_peak * 2 >= scan_bytes:
        raise AssertionError(f"streamed Q1 peak {q1_peak} B is not under "
                             f"half the resident scan's {scan_bytes} B")
    return launches


# ---------------------------------------------------------------- main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import np_tpch_oracle as NO
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.ops import cuda_kernels as CK
    from presto_tpu_torch.tpch.queries import QUERIES

    t_start = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda")
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    t0 = time.perf_counter()
    CK.build()
    say("build", seconds=round(time.perf_counter() - t0, 3),
        kernels=sorted(CK.SOURCES), ptxas={
            name: [ln.strip() for ln in log.splitlines()
                   if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
            for name, log in CK.BUILD_LOG.items()})

    edge_cases(torch, CK, dev)

    requests = {"q1": QUERIES[1], "q6": QUERIES[6], "q14": QUERIES[14],
                "bigint_sum": BIGINT_SUM,
                **{f"q{q}": QUERIES[q] for q in OTHER_QUERIES}}
    runner = LocalRunner(scale_factor=SF)
    t0 = time.perf_counter()
    want = NO.oracle(runner.datasource, tuple(requests))
    say("oracle", seconds=round(time.perf_counter() - t0, 3))

    # the main path: counts reset just before, read just after
    CK.reset_launches()
    per_query, free = {}, {}
    for name, sql in requests.items():
        before = dict(CK.LAUNCHES)
        t0 = time.perf_counter()
        got = runner.run_sql(sql)           # warm-up (first run: ingest)
        warm_up_s = time.perf_counter() - t0
        got = {c: col.to_pylist() for c, col in got.columns.items()}
        if got != want[name]:
            raise AssertionError(f"{name}: {got} != oracle {want[name]}")
        runs = []
        for _ in range(TIMED_RUNS):
            base = peak_start(torch)
            t0 = time.perf_counter()
            table = runner.run_sql(sql)     # materialised to host
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() - base
            if {c: col.to_pylist() for c, col in
                    table.columns.items()} != want[name]:
                raise AssertionError(f"{name}: a timed run disagrees")
        launches = {k: (CK.LAUNCHES[k] - before[k]) // (1 + TIMED_RUNS)
                    for k in CK.LAUNCHES}
        per_query[name] = launches
        free[name] = {"warm_ms": statistics.median(runs), "peak_bytes": peak}
        say("query", name=name, sf=SF, warm_ms_median=statistics.median(runs),
            warm_ms=runs, first_run_s=round(warm_up_s, 3),
            launches_per_run=launches, host_syncs=runner.last_host_syncs,
            peak_bytes=peak, rows=len(next(iter(got.values()))),
            equals_oracle=True)
    launches = dict(CK.LAUNCHES)
    if per_query["q14"]["sorted_probe"] <= 0:
        raise AssertionError("Q14 did not launch sorted_probe")
    if per_query["bigint_sum"]["masked_sum"] <= 0:
        raise AssertionError("the BIGINT sum did not launch masked_sum")
    probed = [q for q in per_query if per_query[q]["sorted_probe"] > 0]
    say("launch_check", sorted_probe_in=probed, required=list(PROBED))
    for q in PROBED:
        if q not in probed:
            raise AssertionError(f"{q} did not launch sorted_probe")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} never launched on the main path")
    distributed = distributed_phase(torch, requests, want, card)
    cluster = cluster_phase(torch, requests, want, card)

    (okey, mask), probe_inputs = path_inputs(torch, runner)
    # the largest launches of the join queries, as the main path forms them
    q3 = largest_probe(torch, CK, runner, requests["q3"], repeated=False)
    repeats = [x for x in (largest_probe(torch, CK, runner, requests[q],
                                         repeated=True)
                           for q in ("q4", "q21")) if x is not None]
    if q3 is None or not repeats:
        raise AssertionError("no sorted_probe launch of Q3, or none into a "
                             "build with repeated keys in Q4 and Q21")
    probe_inputs["q3_largest"] = q3
    probe_inputs["repeated_build_largest"] = max(
        repeats, key=lambda x: x[1].shape[0])
    q1_seg = capture_seg_reduce(torch, CK,
                                lambda: runner.run_sql(requests["q1"]))
    if sorted(q1_seg) != ["add", "count"]:
        raise AssertionError(f"Q1 launched seg_reduce for {sorted(q1_seg)}"
                             ", not for a sum and a count")
    shapes = {"masked_sum": [measure_masked_sum(torch, CK, okey, mask)],
              "sorted_probe": [],
              "seg_reduce": [measure_seg_reduce(
                  torch, CK, f"q1_{kind}", *[x.to(dev) for x in inputs])
                  for kind, inputs in sorted(q1_seg.items())]}
    for s in shapes["seg_reduce"]:
        say("measure", kernel="seg_reduce", **s)
    for shape, inputs in probe_inputs.items():
        s = measure_sorted_probe(torch, CK, shape, *inputs)
        say("measure", kernel="sorted_probe", **s)
        shapes["sorted_probe"].append(s)
    say("like", **measure_like(torch, runner, NO))
    # one set of host columns for the statement phases' oracles
    tables = NO.Tables(runner.datasource)
    scalars = scalars_phase(torch, CK, NO, runner, card, tables)
    strings_dates = strings_dates_phase(torch, CK, NO, runner, card, tables)
    aggregates = aggregates_patterns_phase(torch, CK, NO, runner, card,
                                           tables)
    nested = nested_phase(torch, CK, NO, runner, card, tables)
    del tables
    tpcds = tpcds_phase(torch, CK)
    server = server_phase(torch, CK, NO, requests, want, card)
    tiers = tiers_phase(torch, CK, NO, runner, requests, want, free, card)
    # the scalars, strings and dates, TPC-DS, server and tier paths'
    # largest launches, each held to its plain version and measured in a
    # fresh process
    for shape in measure_apart(torch, {**scalars["captured"],
                                       **strings_dates["captured"],
                                       **aggregates["captured"],
                                       **nested["captured"],
                                       **tpcds["captured"],
                                       **server["captured"],
                                       **tiers["captured"]}):
        say("measure", **shape)
        shapes[shape.pop("kernel")].append(shape)
    kernels = []
    for name in sorted(CK.SOURCES):
        s = shapes[name][0]  # the main path's shape
        by_path = {"tpch": launches[name],
                   "scalars": scalars["launches"][name],
                   "strings_dates": strings_dates["launches"][name],
                   "aggregates_patterns": aggregates["launches"][name],
                   "aggregates_streamed":
                       aggregates["streamed_launches"][name],
                   "nested": nested["launches"][name],
                   "distributed": distributed["launches"][name],
                   "cluster": cluster["launches"][name],
                   "tpcds": tpcds["launches"][name],
                   "server": server["launches"][name],
                   "tiers": tiers["launches"]["tiers"][name],
                   "streamed": tiers["launches"]["streamed"][name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"presto_tpu_torch/csrc/{CK.SOURCES[name]}",
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in shapes[name]),
            "ms": s["call_ms"], "call_ms": s["call_ms"],
            "device_ms": s["device_ms"], "kernel_ms": s["device_ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "library_device_ms": s["library_device_ms"],
            "max_abs_diff_vs_plain": s["max_abs_err"],
            "shape": s["shape"], "shapes": shapes[name], "card": card})
    say("done", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(measure_probes(sys.argv[2]) if sys.argv[1:2] == [MEASURE_ARG]
             else stream_oracle(*sys.argv[2:6])
             if sys.argv[1:2] == [STREAM_ORACLE_ARG] else main())
