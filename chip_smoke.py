#!/usr/bin/env python3
"""Drive presto_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the script exits
non-zero without printing a result):

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: compile every CUDA kernel from ``presto_tpu_torch/csrc``;
3. kernels: each kernel's wrapper on card tensors, exactly equal to its
   plain PyTorch version, at edge cases and at the shapes the main path
   gives it; kernel, plain and library times are medians of 20 samples
   timed with CUDA events;
4. queries: ``LocalRunner(scale_factor=1.0)`` on cuda runs TPC-H Q1, Q6,
   Q14 and a BIGINT sum through ``run_sql`` (one warm-up, then 5 timed
   runs each), every result equal to a numpy oracle over the same
   generated tables; the kernels' launch counts are reset just before and
   read just after, and each kernel must have launched;
5. a ``kernels`` JSON line, then the card line, then the result line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without a CUDA device, and in a directory that holds
no ``presto_tpu_torch`` package.
"""

from __future__ import annotations

import datetime as dt
import json
import os
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

BIGINT_SUM = ("SELECT sum(l_orderkey) AS s, count(*) AS c FROM lineitem "
              "WHERE l_shipdate <= DATE '1998-09-02'")
REPLACES = {"masked_sum": "presto_tpu/ops/pallas_kernels.py:103",
            "sorted_probe": "presto_tpu/ops/pallas_kernels.py:196"}


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, sort_keys=True), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn) -> float:
    """Median over SAMPLES of the per-call time of CALLS back-to-back calls,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(SAMPLES):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(CALLS):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / CALLS)
    return statistics.median(times)


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
    keys = torch.sort(torch.randint(-10**12, 10**12, (200_000,),
                                    generator=gen)).values.to(dev)
    probes = torch.cat([
        keys[torch.randint(0, 200_000, (500_000,), generator=gen).to(dev)],
        torch.randint(-2 * 10**12, 2 * 10**12, (499_998,),
                      generator=gen).to(dev),
        torch.tensor([-2**63, 2**63 - 1], device=dev)])
    for n_valid in (200_000, 123_457, 0):
        nv = torch.tensor(n_valid, device=dev)
        check_sorted_probe(torch, CK, keys, probes, nv, f"n_valid={n_valid}")
    say("kernels", kernel="sorted_probe", edge_cases="n=200k keys with "
        "negatives, P=1M probes with misses, n_valid in 200k,123457,0",
        max_abs_err=0)


def path_inputs(torch, runner):
    """The kernels' inputs as the main path forms them: the BIGINT sum's
    l_orderkey column with its filter mask (masked_sum), and Q14's sorted
    part keys against the lineitem keys of its month (sorted_probe)."""
    ds = runner.datasource
    li = ds.scan("lineitem", ("l_orderkey", "l_partkey", "l_shipdate"))
    part = ds.scan("part", ("p_partkey",))
    ship = li.cols["l_shipdate"].values
    okey = li.cols["l_orderkey"].values.contiguous()
    mask = (ship <= days("1998-09-02")).contiguous()
    window = (ship >= days("1995-09-01")) & (ship < days("1995-10-01"))
    probes = li.cols["l_partkey"].values[window].contiguous()
    keys = torch.sort(part.cols["p_partkey"].values).values.contiguous()
    n_valid = torch.tensor(keys.shape[0], device=keys.device)
    return (okey, mask), (keys, probes, n_valid)


def measure(torch, CK, ms_inputs, sp_inputs):
    okey, mask = ms_inputs
    keys, probes, n_valid = sp_inputs
    n, p, k = okey.shape[0], probes.shape[0], keys.shape[0]
    out = {
        "masked_sum": dict(
            max_abs_err=check_masked_sum(torch, CK, okey, mask, "path"),
            ms=median_ms(torch, lambda: CK.masked_sum(okey, mask)),
            plain_ms=median_ms(torch, lambda: CK.masked_sum_plain(okey, mask)),
            library_ms=median_ms(torch, lambda: torch.where(mask, okey, 0)
                                 .sum()),
            bound_ms=(9 * n + 8) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            shape=f"N={n} int64 values + bool mask"),
        "sorted_probe": dict(
            max_abs_err=check_sorted_probe(torch, CK, keys, probes, n_valid,
                                           "path"),
            ms=median_ms(torch, lambda: CK.sorted_probe(keys, probes,
                                                        n_valid)),
            plain_ms=median_ms(torch, lambda: CK.sorted_probe_plain(
                keys, probes, n_valid)),
            library_ms=median_ms(torch, lambda: torch.searchsorted(
                keys[:k], probes, side="left")),
            bound_ms=(12 * p + 8 * k + 8) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes",
            shape=f"n={k} sorted int64 keys, P={p} int64 probes"),
    }
    return out


# ---------------------------------------------------------------- oracle

def days(iso: str) -> int:
    return (dt.date.fromisoformat(iso) - dt.date(1970, 1, 1)).days


def div_half_up(num: int, den: int) -> int:
    sign = -1 if (num < 0) != (den < 0) else 1
    q, r = divmod(abs(num), abs(den))
    return sign * (q + (2 * r >= abs(den)))


def oracle(ds) -> dict:
    """The four requests in numpy over the port's own host tables, with
    exact integer arithmetic (every int64 sum here stays below 2^63 at
    SF1; products that could not are taken in python ints)."""
    li = ds.read_host("lineitem", (
        "l_orderkey", "l_partkey", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_returnflag", "l_linestatus", "l_shipdate"))
    part = ds.read_host("part", ("p_partkey", "p_type"))
    col = {k: np.asarray(c.values) for k, c in li.items()}
    ship, ep, disc = col["l_shipdate"], col["l_extendedprice"], \
        col["l_discount"]
    out = {}

    m = ship <= days("1998-12-01") - 90
    rf_d, ls_d = li["l_returnflag"].dictionary, li["l_linestatus"].dictionary
    gid = col["l_returnflag"][m].astype(np.int64) * len(ls_d) \
        + col["l_linestatus"][m]
    disc_price = ep[m] * (100 - disc[m])
    fields = {"sum_qty": col["l_quantity"][m], "sum_base_price": ep[m],
              "sum_disc_price": disc_price,
              "sum_charge": disc_price * (100 + col["l_tax"][m]),
              "disc": disc[m]}
    groups = sorted(np.unique(gid).tolist(),
                    key=lambda g: (str(rf_d[g // len(ls_d)]),
                                   str(ls_d[g % len(ls_d)])))
    q1 = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty",
                          "sum_base_price", "sum_disc_price", "sum_charge",
                          "avg_qty", "avg_price", "avg_disc", "count_order")}
    for g in groups:
        sel = gid == g
        cnt = int(sel.sum())
        s = {k: int(v[sel].sum()) for k, v in fields.items()}
        q1["l_returnflag"].append(str(rf_d[g // len(ls_d)]))
        q1["l_linestatus"].append(str(ls_d[g % len(ls_d)]))
        for k in ("sum_qty", "sum_base_price", "sum_disc_price",
                  "sum_charge"):
            q1[k].append(s[k])
        q1["avg_qty"].append(div_half_up(s["sum_qty"], cnt))
        q1["avg_price"].append(div_half_up(s["sum_base_price"], cnt))
        q1["avg_disc"].append(div_half_up(s["disc"], cnt))
        q1["count_order"].append(cnt)
    out["q1"] = q1

    m = ((ship >= days("1994-01-01")) & (ship < days("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (col["l_quantity"] < 2400))
    out["q6"] = {"revenue": [int((ep[m] * disc[m]).sum())]}

    m = (ship >= days("1995-09-01")) & (ship < days("1995-10-01"))
    pkey = np.asarray(part["p_partkey"].values)
    order = np.argsort(pkey, kind="stable")
    pos = order[np.searchsorted(pkey[order], col["l_partkey"][m])]
    promo_code = np.array([str(s).startswith("PROMO")
                           for s in part["p_type"].dictionary])
    promo = promo_code[np.asarray(part["p_type"].values)[pos]]
    rev = ep[m] * (100 - disc[m])
    out["q14"] = {"promo_revenue": [div_half_up(
        10000 * int(rev[promo].sum()) * 10**4, int(rev.sum()))]}

    m = ship <= days("1998-09-02")
    out["bigint_sum"] = {"s": [int(col["l_orderkey"][m].sum())],
                         "c": [int(m.sum())]}
    return out


# ---------------------------------------------------------------- main

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
        kernels=sorted(CK.SOURCES))

    edge_cases(torch, CK, dev)

    requests = {"q1": QUERIES[1], "q6": QUERIES[6], "q14": QUERIES[14],
                "bigint_sum": BIGINT_SUM}
    runner = LocalRunner(scale_factor=SF)
    t0 = time.perf_counter()
    want = oracle(runner.datasource)
    say("oracle", seconds=round(time.perf_counter() - t0, 3))

    # the main path: counts reset just before, read just after
    CK.reset_launches()
    per_query = {}
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
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            table = runner.run_sql(sql)     # materialised to host
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
            if {c: col.to_pylist() for c, col in
                    table.columns.items()} != want[name]:
                raise AssertionError(f"{name}: a timed run disagrees")
        launches = {k: (CK.LAUNCHES[k] - before[k]) // (1 + TIMED_RUNS)
                    for k in CK.LAUNCHES}
        per_query[name] = launches
        say("query", name=name, sf=SF, warm_ms_median=statistics.median(runs),
            warm_ms=runs, first_run_s=round(warm_up_s, 3),
            launches_per_run=launches, host_syncs=runner.last_host_syncs,
            rows=len(next(iter(got.values()))), equals_oracle=True)
    launches = dict(CK.LAUNCHES)
    if per_query["q14"]["sorted_probe"] <= 0:
        raise AssertionError("Q14 did not launch sorted_probe")
    if per_query["bigint_sum"]["masked_sum"] <= 0:
        raise AssertionError("the BIGINT sum did not launch masked_sum")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} never launched on the main path")

    ms_inputs, sp_inputs = path_inputs(torch, runner)
    stats = measure(torch, CK, ms_inputs, sp_inputs)
    kernels = []
    for name in sorted(CK.SOURCES):
        s = stats[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"presto_tpu_torch/csrc/{CK.SOURCES[name]}",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "max_abs_diff_vs_plain": s["max_abs_err"], "kernel_ms": s["ms"],
            "shape": s["shape"], "card": card})
    say("done", seconds=round(time.perf_counter() - t_start, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
