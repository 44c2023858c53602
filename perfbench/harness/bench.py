"""One run of one cell: set-up, the measured window, the check.

    python3 perfbench/run.py --workload tpch-sf1.power --seed 7 \
        --seconds 10 --trace 0

Set-up makes the configuration's tables with its generator (on the
card), checks their row counts against the configuration's ``tables``,
opens the traffic's driver with the tables attached through the
configuration's connector, and runs the stream once untimed for each
parameter set of the traffic's pool, which plans every statement,
uploads the columns and builds the kernels. The window then runs the
traffic's ``clients``, each a closed loop: a client sends the stream's
statements one after another, each timed by the host's clock from
``execute`` to the last row, between two ``torch.cuda.synchronize()``,
until ``--seconds`` have passed. After the window one more stream, with
parameters drawn from ``--seed`` itself, is answered untimed; then the
program is freed, the configuration's reference computes each distinct
statement once, and every statement of the window and of that stream is
compared with it in full (``harness/compare.py``).

With ``--trace 1`` the first rounds of the window (the traffic's
``trace_streams``; a round is one stream from every client) each run
under their own profiler session and the run reports the cell's
per-layer metrics; with ``--trace 0`` it reports the end-to-end ones.
The last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

from . import params as P
from . import trace as TR
from .compare import compare
from .spec import Cell, load_cell, peaks

FORBIDDEN = ("jax", "jaxlib", "flax", "presto_tpu")


def process_start_s() -> float:
    """This process's start on ``CLOCK_BOOTTIME`` (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def since_start_s(start: float) -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Results:
    """The distinct results of each statement, kept once: a statement's
    record holds the index of its result here, so the rows held stay as
    many as the distinct answers, not as the statements."""

    def __init__(self):
        self.distinct: Dict[tuple, list] = defaultdict(list)
        self.records: List[dict] = []
        self._lock = threading.Lock()

    def keep(self, record: dict) -> None:
        with self._lock:
            self.records.append(record)
            if record["failed"]:
                return
            got = (record.pop("columns"), record.pop("rows"))
            seen = self.distinct[record["query"], record["set"]]
            record["result"] = next(
                (i for i, r in enumerate(seen) if r == got), len(seen))
            if record["result"] == len(seen):
                seen.append(got)


def timed(client, name: str, sql: str, sync) -> dict:
    """One statement through the driver's client, timed by the host's
    clock from ``execute`` to the last row."""
    sync()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(f"stmt:q{name}"):
            columns, rows, host_syncs = client.execute(sql)
        failed = None
    except Exception as e:  # noqa: BLE001 - a failed statement is counted
        rows, columns, host_syncs = None, None, None
        failed = f"{type(e).__name__}: {e}"
    sync()
    return {"query": name, "ms": (time.perf_counter() - t0) * 1e3,
            "rows": rows, "columns": columns, "failed": failed,
            "host_syncs": host_syncs}


def concurrently(fns: List[Callable[[], None]]) -> None:
    """Run ``fns`` at once, one thread each (inline when there is one)."""
    if len(fns) == 1:
        fns[0]()
        return
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def judge(ref, tables, results: Results, statements: dict,
          sets: List[dict], log) -> Dict[str, int]:
    """Every kept statement against the reference, computed once per
    distinct statement; each distinct result is compared in full."""
    wrong = failed = 0
    by_statement = defaultdict(list)
    for r in results.records:
        by_statement[r["query"], r["set"]].append(r)
    for (q, p), recs in by_statement.items():
        t0 = time.perf_counter()
        cols, want = ref.answer(tables, q, sets[p][q][1])
        order = statements["queries"][q]["order"]
        whys = [f"columns {c}, the reference has {cols}" if c != cols
                else compare(rows, want, cols, order)
                for c, rows in results.distinct[q, p]]
        for r in recs:
            if r["failed"]:
                failed += 1
                log(f"statement q{q} set {p} failed: {r['failed'][:400]}")
            elif whys[r["result"]] is not None:
                wrong += 1
                log(f"statement q{q} set {p} wrong: {whys[r['result']]}")
        log(f"reference q{q} set {p}: {len(want)} rows in "
            f"{time.perf_counter() - t0:.3f} s, {len(recs)} statements")
    return {"wrong_statements": wrong, "failed_statements": failed}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        start_s: float, log=lambda s: None) -> dict:
    """One run; returns the result (without the check of loaded
    modules, which the caller makes last)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
    log(f"set-up: device ready at {since_start_s(start_s):.3f} s")
    gen, ref = cell.generator(), cell.reference()
    connector, driver = cell.connector(), cell.driver()
    log(f"set-up: modules loaded at {since_start_s(start_s):.3f} s")

    sf = float(cell.config["scale_factor"])
    t0 = time.perf_counter()
    host = gen.generate(sf, device)
    if cuda:
        torch.cuda.empty_cache()
    rows = {t: next(iter(c.values())).rows for t, c in host.items()}
    log(f"set-up: SF{sf:g} tables made in {time.perf_counter() - t0:.3f} s "
        f"(at {since_start_s(start_s):.3f} s): "
        + ", ".join(f"{t} {n}" for t, n in rows.items()))
    if rows != cell.config["tables"]:
        raise ValueError(f"the generator made {rows}; the configuration "
                         f"states {cell.config['tables']}")

    session = driver.open(sf, device,
                          lambda runner: connector.attach(runner, host),
                          int(cell.traffic["clients"]))
    clients = session.clients
    pool = P.parameter_sets(cell.statements, cell.traffic, sf, seed)
    own = len(pool)  # the run's own set, answered after the window
    sets = pool + [P.draw_statements(cell.statements, sf, seed)]
    stream = [str(q) for q in cell.traffic["stream"]]
    t0 = time.perf_counter()
    for drawn in pool:  # warm-up: plans, uploads, kernel builds
        for q in stream:
            r = timed(clients[0], q, drawn[q][0], sync)
            if r["failed"]:
                log(f"warm-up q{q} failed: {r['failed'][:400]}")
    log(f"set-up: {len(pool)} warm-up streams in "
        f"{time.perf_counter() - t0:.3f} s (at "
        f"{since_start_s(start_s):.3f} s)")

    recorder = TR.Recorder()
    kernels = None
    to_trace = int(cell.traffic.get("trace_streams", 0)) if trace and cuda \
        else 0
    if to_trace:
        from presto_tpu_torch.ops import cuda_kernels as kernels
    gc.collect()
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = since_start_s(start_s)
    results = Results()
    profiled = []
    counter = itertools.count()
    w0 = time.perf_counter()
    deadline = w0 + seconds

    def one_stream(i: int, k: int, check_deadline: bool) -> None:
        p = k % len(pool)
        for q in stream:
            rec = timed(clients[i], q, sets[p][q][0], sync)
            rec.update(set=p, client=i, end=time.perf_counter() - w0)
            results.keep(rec)
            if check_deadline and time.perf_counter() >= deadline:
                return

    def closed_loop(i: int) -> None:
        while time.perf_counter() < deadline:
            one_stream(i, next(counter), True)

    for _ in range(to_trace):
        kernels.set_probe_recorder(recorder.probe)
        profiled.append(TR.profile_stream(
            lambda: concurrently([
                (lambda i=i, k=next(counter): one_stream(i, k, False))
                for i in range(len(clients))]), recorder))
        kernels.set_probe_recorder(None)
        if time.perf_counter() >= deadline:
            break
    concurrently([(lambda i=i: closed_loop(i))
                  for i in range(len(clients))])
    window_s = time.perf_counter() - w0
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    records = list(results.records)
    n_streams = next(counter)
    thirds = [0, 0, 0]
    for r in records:
        thirds[min(int(3 * r["end"] / window_s), 2)] += 1
    log(f"window: {len(records)} statements in {window_s} s ({n_streams} "
        f"streams, {len(clients)} clients; by thirds of the window "
        f"{thirds}); setup {setup_s} s")

    for q in stream:  # the seed's own parameters, untimed
        rec = timed(clients[0], q, sets[own][q][0], sync)
        rec.update(set=own, client=0)
        results.keep(rec)
    process_peak = max(setup_peak, torch.cuda.max_memory_allocated()) \
        if cuda else 0

    t0 = time.perf_counter()
    streams = [TR.summarize(*p) for p in profiled]
    del profiled
    if streams:
        log(f"traces read in {time.perf_counter() - t0:.3f} s")
    for i, st in enumerate(streams):
        log(f"trace round {i}: device_ops {st.device_ops}, busy_s "
            f"{st.busy_s}, wall_s {st.wall_s}, launches "
            + ", ".join(f"{k} {len(v)}" for k, v in st.launches.items()))
    by_q = defaultdict(list)
    for r in records:
        by_q[r["query"], r["set"]].append(r["ms"])
    for p, drawn in enumerate(sets):
        for q in stream:
            if by_q[q, p]:
                ms = by_q[q, p]
                log(f"latency q{q} set {p}: n {len(ms)}, median_ms "
                    f"{statistics.median(ms)}, max_ms {max(ms)}, "
                    f"params {json.dumps(drawn[q][1])}")
    log(f"the seed's own set (set {own}): params "
        + json.dumps({q: sets[own][q][1] for q in stream}))

    session.close()
    del session, clients
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check = judge(ref, ref.Tables(host, device), results, cell.statements,
                  sets, log)
    log(f"compared {len(results.records)} statements: {len(records)} of "
        f"the window, {len(results.records) - len(records)} of the seed's "
        f"own set; reference and comparison in "
        f"{time.perf_counter() - t0:.3f} s")

    card = card_power_limit() if cuda else "cpu"
    peak_table = peaks(cell.bench_dir)
    ctx = {"statements": records, "window_s": window_s, "setup_s": setup_s,
           "window_peak_bytes": window_peak, "streams": streams,
           "roofline": cell.roofline, "card": card,
           "peak": next((v for k, v in peak_table.items()
                         if k != "about" and k in card), None)}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for r in records if r["failed"])
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 1,
                   "memory_peak_bytes": process_peak}
    result = {"correct": len(records) > 0 and check["wrong_statements"] == 0
              and check["failed_statements"] == 0,
              "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = sum(st.busy_s for st in streams)
        device_info["window_s"] = sum(st.wall_s for st in streams)
        result["breakdown"] = TR.breakdown(streams)
        log(f"card: {card}")
    result["check"] = {
        "wrong_statements": {"value": check["wrong_statements"], "limit": 0},
        "failed_statements": {"value": check["failed_statements"],
                              "limit": 0}}
    return result


def main(argv=None) -> int:
    start_s = process_start_s()
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(s):
        print(f"perfbench: {s}", file=sys.stderr, flush=True)

    log(f"set-up: python and torch imported at "
        f"{since_start_s(start_s):.3f} s")
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 start_s, log)
    bad = forbidden_modules()
    if bad:
        log(f"loaded after the window: {', '.join(bad)} (JAX or the JAX "
            "package); no result")
        return 4
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
