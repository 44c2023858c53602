#!/usr/bin/env python3
"""Where a traced statement's host time goes, by the program's spans
(``presto_tpu_torch/utils/tracing.py``), on the card.  Card only.

    python3 tools/span_report.py --workload tpch-sf1.power --seed 7 \
        --streams 3 [--syncs] [--overhead]

(``--device cpu --scale 0.01`` runs the streams and the overhead on the
CPU at SF0.01, a dry run of the script.)

Sets the cell up as ``perfbench/run.py`` does (its generator, connector,
driver and parameter pool; one untimed stream per set), then:

- runs ``--streams`` streams, each under its own profiler session
  (``perfbench/harness/trace.py``), and reports per statement whether
  its ``host_read`` spans equal its ``host_syncs``; the ``statement``
  span's self time as a share of its duration; each span name's self and
  inclusive ms per statement, and by query; and the idle gaps inside
  statements by label, with the share labelled ``python`` or
  ``statement``;
- with ``--syncs``, runs each statement of the stream once more under
  ``torch.cuda.set_sync_debug_mode("warn")`` and a CPU profiler session
  (so the spans are on): each synchronizing operation the card reports
  is counted (inside a ``host_read`` span) or missed, per query, with the
  program line of each missed one;
- with ``--overhead``, times a span site with tracing off (``with
  span(...)``, ``host_read()``, a decorated call) and a span with it on,
  per call;
- with ``--ab N``, runs N pairs of traced streams in turns, one with the
  spans on and one with them held off (the tracer's profiler flag read
  as False), and reports each side's stream wall: what the spans cost a
  traced stream, inside one process.

Prints a summary and writes everything to ``--out`` (by default
``build/span_report_<workload>_<seed>.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import warnings
from collections import Counter, defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "perfbench")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
sys.path[:0] = [BENCH, ROOT]

import torch  # noqa: E402

from harness import params as P  # noqa: E402
from harness import trace as TR  # noqa: E402
from harness.spec import load_cell  # noqa: E402
from presto_tpu_torch.utils import tracing  # noqa: E402


def setup(cell, seed: int, device: str, scale):
    gen, connector, driver = cell.generator(), cell.connector(), \
        cell.driver()
    sf = float(scale or cell.config["scale_factor"])
    host = gen.generate(sf, device)
    session = driver.open(sf, device, lambda r: connector.attach(r, host), 1)
    pool = P.parameter_sets(cell.statements, cell.traffic, sf, seed)
    stream = [str(q) for q in cell.traffic["stream"]]
    client = session.clients[0]
    for drawn in pool:
        for q in stream:
            client.execute(drawn[q][0])
    torch.cuda.synchronize()
    return session, client, pool, stream


def run_stream(client, drawn, stream):
    """[(query, query id, host syncs, ms)] of one stream."""
    out = []
    for q in stream:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"stmt:q{q}"):
            _, _, syncs = client.execute(drawn[q][0])
        torch.cuda.synchronize()
        out.append((q, client.cursor.last_query.query_id, syncs,
                    (time.perf_counter() - t0) * 1e3))
    return out


def span_stats(records):
    """Per name: [count, inclusive ns, self ns] of one statement's
    records; a nested same-name span is not counted twice inclusive."""
    kids = defaultdict(int)
    for r in records:
        if r[2] is not None:
            kids[r[2]] += r[5] - r[4]
    by_id = {r[1]: r for r in records}
    out = defaultdict(lambda: [0, 0, 0])
    for r in records:
        s = out[r[3]]
        s[0] += 1
        s[2] += r[5] - r[4] - kids[r[1]]
        p, nested = r[2], False
        while p is not None and not nested:
            nested = by_id[p][3] == r[3]
            p = by_id[p][2]
        if not nested:
            s[1] += r[5] - r[4]
    return out


def streams_phase(client, pool, stream, n):
    rounds = []
    per_query = defaultdict(lambda: defaultdict(lambda: [0, 0, 0]))
    checks = []
    gaps = Counter()
    for k in range(n):
        drawn = pool[k % len(pool)]
        holder = {}
        prof, wall, launches = TR.profile_stream(
            lambda: holder.setdefault("s", run_stream(client, drawn, stream)),
            TR.Recorder())
        st = TR.summarize(prof, wall, launches)
        del prof
        ring = dict(tracing.statements())
        stmts = []
        for q, qid, syncs, ms in holder["s"]:
            recs = ring[qid]
            stats = span_stats(recs)
            reads = stats["host_read"][0]
            root = stats["statement"]
            checks.append({"query": q, "host_syncs": syncs,
                           "host_read_spans": reads,
                           "equal": reads == syncs})
            for name, v in stats.items():
                for i in range(3):
                    per_query[q][name][i] += v[i]
            stmts.append({"query": q, "ms": ms, "statement_ns": root[1],
                          "statement_self_ns": root[2]})
        gaps.update(st.gaps_s)
        rounds.append({"wall_s": wall, "device_ops": st.device_ops,
                       "busy_s": st.busy_s, "statements": stmts})
    total = defaultdict(lambda: [0, 0, 0])
    for q, names in per_query.items():
        for name, v in names.items():
            for i in range(3):
                total[name][i] += v[i]
    n_stmt = sum(len(r["statements"]) for r in rounds)
    inside = {k: v for k, v in gaps.items() if not k.startswith("- ")}
    labelled = sum(inside.values())
    blind = sum(v for k, v in inside.items()
                if k.split(" ", 1)[1] in ("python", "statement"))
    st_ns = sum(s["statement_ns"] for r in rounds for s in r["statements"])
    st_self = sum(s["statement_self_ns"] for r in rounds
                  for s in r["statements"])
    return {
        "rounds": rounds,
        "host_read_equals_host_syncs": all(c["equal"] for c in checks),
        "mismatches": [c for c in checks if not c["equal"]],
        "statement_self_share": st_self / st_ns if st_ns else None,
        "per_statement_ms": {
            name: {"count": v[0] / n_stmt, "inclusive_ms": v[1] / 1e6 / n_stmt,
                   "self_ms": v[2] / 1e6 / n_stmt}
            for name, v in sorted(total.items(), key=lambda kv: -kv[1][2])},
        "per_query_self_ms": {
            q: {name: v[2] / 1e6 / n for name, v in sorted(
                names.items(), key=lambda kv: -kv[1][2])[:6]}
            for q, names in per_query.items()},
        "in_statement_gap_s": labelled,
        "python_or_statement_gap_s": blind,
        "python_or_statement_share": blind / labelled if labelled else None,
        "top_gaps": sorted(inside.items(), key=lambda kv: -kv[1])[:20],
        "totals": {k: list(v) for k, v in tracing.totals().items()},
    }


def syncs_phase(client, drawn, stream):
    """Per query: the synchronizing operations the card reports while
    the statement runs, inside a host_read span or not."""
    out = {}
    for q in stream:
        seen = []

        def show(message, category, filename, lineno, file=None, line=None):
            o = tracing._thread.open
            seen.append((o is not None and o.name == "host_read",
                         f"{os.path.relpath(filename, ROOT)}:{lineno}",
                         None if o is None else o.name))

        client.execute(drawn[q][0])
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            old, warnings.showwarning = warnings.showwarning, show
            try:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]):
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        _, _, syncs = client.execute(drawn[q][0])
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
            finally:
                warnings.showwarning = old
        missed = Counter((at, where) for ok, at, where in seen if not ok)
        out[q] = {"host_syncs": syncs,
                  "reported": len(seen),
                  "counted": sum(ok for ok, _, _ in seen),
                  "missed": sum(missed.values()),
                  "missed_at": [[at, where, n]
                                for (at, where), n in missed.most_common()]}
    return out


def overhead_phase(n=1_000_000):
    """ns per call of a span site with tracing off."""
    from presto_tpu_torch.utils.tracing import host_read, span

    class Ctx:
        host_syncs = 0

    ctx = Ctx()

    @span("overhead_probe")
    def decorated():
        return None

    def bare():
        return None

    def loop(body):
        t0 = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t0) / n

    def empty():
        for _ in range(n):
            pass

    def with_span():
        for _ in range(n):
            with span("op:Probe"):
                pass

    def with_read():
        for _ in range(n):
            with host_read(ctx):
                pass

    def calls(fn):
        def body():
            for _ in range(n):
                fn()
        return body

    out = {}
    for _ in range(3):  # the last of three rounds
        base = loop(empty)
        out = {"loop_ns": base,
               "span_ns": loop(with_span) - base,
               "host_read_ns": loop(with_read) - base,
               "decorated_call_ns": loop(calls(decorated)) - loop(calls(bare))}
    n = 100_000
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        out["span_on_ns"] = loop(with_span) - loop(empty)
    return out


class _Off:
    """Stands in for ``torch.autograd.profiler`` in the tracer: the
    spans read the profiler as off."""
    _is_profiler_enabled = False


def ab_phase(client, pool, stream, pairs):
    """Traced streams' wall with the spans on and held off, in turns."""
    real = tracing._profiler
    walls = {"on": [], "off": []}
    for k in range(pairs):
        for mode in ("on", "off") if k % 2 == 0 else ("off", "on"):
            tracing._profiler = real if mode == "on" else _Off
            try:
                prof, wall, _ = TR.profile_stream(
                    lambda: run_stream(client, pool[k % len(pool)], stream),
                    TR.Recorder())
            finally:
                tracing._profiler = real
            del prof
            walls[mode].append(wall)
    on, off = (statistics.median(walls[m]) for m in ("on", "off"))
    return {"walls": walls, "median_on_s": on, "median_off_s": off,
            "rise": on / off - 1}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="tpch-sf1.power")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--streams", type=int, default=3)
    ap.add_argument("--syncs", action="store_true")
    ap.add_argument("--overhead", action="store_true")
    ap.add_argument("--ab", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.device == "cpu":
        torch.cuda.synchronize = lambda *a: None  # a dry run
    elif not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 3
    report = {"workload": args.workload, "seed": args.seed,
              "torch": torch.__version__,
              "card": torch.cuda.get_device_name(0)
              if args.device != "cpu" else "cpu"}
    if args.overhead:
        report["overhead_off"] = overhead_phase()
        print("overhead_off", json.dumps(report["overhead_off"]), flush=True)
    cell = load_cell(args.workload)
    t0 = time.perf_counter()
    session, client, pool, stream = setup(cell, args.seed, args.device,
                                          args.scale)
    print(f"set up in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.streams:
        s = streams_phase(client, pool, stream, args.streams)
        report["streams"] = s
        print("host_read == host_syncs:", s["host_read_equals_host_syncs"],
              s["mismatches"][:5])
        print("statement self share:", s["statement_self_share"])
        print("python/statement share of in-statement gaps:",
              s["python_or_statement_share"], "of",
              s["in_statement_gap_s"], "s")
        print("rounds:", [(r["wall_s"], r["device_ops"], r["busy_s"])
                          for r in s["rounds"]])
        for name, v in list(s["per_statement_ms"].items())[:12]:
            print(f"  {name}: {json.dumps(v)}")
        print("top gaps:", json.dumps(s["top_gaps"][:12]))
        ms = defaultdict(list)
        for r in s["rounds"]:
            for st in r["statements"]:
                ms[st["query"]].append(st["ms"])
        print("median ms:", json.dumps(
            {q: round(statistics.median(v), 3) for q, v in ms.items()}))
    if args.ab:
        report["ab"] = ab_phase(client, pool, stream, args.ab)
        print("ab", json.dumps(report["ab"]), flush=True)
    if args.syncs:
        report["syncs"] = syncs_phase(client, pool[0], stream)
        for q, v in report["syncs"].items():
            print(f"  syncs q{q}: {json.dumps(v)[:600]}")
    path = args.out or os.path.join(
        ROOT, "build", f"span_report_{args.workload}_{args.seed}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
