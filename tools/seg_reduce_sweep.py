#!/usr/bin/env python3
"""``seg_reduce`` at the TPC-H power stream's launches, on one CUDA card.
Card only.

    python3 tools/seg_reduce_sweep.py [--workload tpch-sf1.power,tpch-sf10.power]
                                      [--samples 5] [--reps 5] [--sweep]

For each cell, sets its tables up as ``perfbench/run.py`` does (its
generator, connector and DB-API connection) and runs the stream once with
the pool's first parameter set.  Then:

- ``launches``: one stream's ``seg_reduce`` launches by statement: how many,
  how many took the privatised branch, the largest capacity of each branch,
  the rows they read, and the capacities up to 8,192 they used.
- ``ab``: each statement of the stream timed on the host's clock with the
  kernel and with the library scatter in its place (``seg_reduce_plain`` on
  the card: the spare-slot index and a colliding ``index_add_`` /
  ``scatter_reduce_``, the aggregation layer's path before the kernel), the
  two in turns in this one process, ``--reps`` times each; one line a
  statement with both medians, then the stream's sum and geometric mean.
- ``measure``: the largest sum and count launch of Q1 (privatised), Q18, Q16
  and Q10 (the global branch), each measured apart in a fresh process by
  ``chip_smoke.measure_apart`` (call and device time of the kernel, its plain
  version, the library scatter alone, the byte bound).  A shape whose
  measurement fails prints a ``failed`` line and the others go on.
- with ``--sweep``, Q1's two launches also under other plans (blocks per SM,
  privatised or global), each result checked against the plain version, one
  ``plan`` line per plan (``chip_smoke.call_ms``: CUDA events around 10
  back-to-back launches, median of ``--samples``), the plan
  ``cuda_kernels.seg_reduce_plan`` picks marked ``"chosen"``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "perfbench"), ROOT]

MEASURED = (1, 18, 16, 10)   # statements whose launches are measured apart
SMALL_CAPACITY = 8192        # capacities up to this are listed by statement


def open_cell(workload: str, seed: int):
    """(client, the stream's statement numbers, their SQL by number) of
    ``workload``'s tables on the card, the pool's first parameter set."""
    from harness import params as P
    from harness.spec import load_cell
    cell = load_cell(workload)
    sf = float(cell.config["scale_factor"])
    host = cell.generator().generate(sf, "cuda")
    session = cell.driver().open(
        sf, "cuda", lambda r: cell.connector().attach(r, host), 1)
    drawn = P.parameter_sets(cell.statements, cell.traffic, sf, seed)[0]
    return session.clients[0], list(cell.traffic["stream"]), \
        {q: drawn[str(q)][0] for q in cell.traffic["stream"]}


def census(torch, CK, client, stream, sql, card) -> dict:
    """One stream's launches, summed by statement (``launches`` lines)."""
    real, seen = CK.seg_reduce, []
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def record(values, slot, mask, capacity, op="add"):
        if slot.is_cuda and slot.shape[0] and capacity:
            seen.append((slot.shape[0], capacity,
                         CK.seg_reduce_plan(slot.shape[0], capacity, sms)[2]))
        return real(values, slot, mask, capacity, op)

    CK.seg_reduce = record
    by_q = {}
    try:
        for q in stream:
            seen.clear()
            client.execute(sql[q])
            priv = [(n, c) for n, c, p in seen if p]
            glob = [(n, c) for n, c, p in seen if not p]
            by_q[q] = dict(
                launches=len(seen), privatised=len(priv),
                privatised_max_capacity=max((c for _, c in priv), default=0),
                global_max_capacity=max((c for _, c in glob), default=0),
                privatised_rows=sum(n for n, _ in priv),
                global_rows=sum(n for n, _ in glob),
                small_capacities=sorted({c for _, c, _ in seen
                                         if c <= SMALL_CAPACITY}))
    finally:
        CK.seg_reduce = real
    total = {k: sum(v[k] for v in by_q.values())
             for k in ("launches", "privatised", "privatised_rows",
                       "global_rows")}
    print("[launches] " + json.dumps(dict(total=total, by_statement=by_q,
                                          card=card)), flush=True)
    return by_q


def ab(torch, CK, client, stream, sql, reps: int, card) -> None:
    """Each statement with the kernel and with the library scatter, in
    turns (``ab`` lines, ms on the host's clock)."""
    real = CK.seg_reduce
    sides = {"kernel": real, "library": CK.seg_reduce_plain}
    ms = {q: {s: [] for s in sides} for q in stream}
    try:
        for r in range(reps):
            for q in stream:
                for side in (("kernel", "library") if r % 2 == 0
                             else ("library", "kernel")):
                    CK.seg_reduce = sides[side]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    client.execute(sql[q])
                    ms[q][side].append((time.perf_counter() - t0) * 1e3)
    finally:
        CK.seg_reduce = real
    med = {q: {s: statistics.median(v) for s, v in m.items()}
           for q, m in ms.items()}
    for q in stream:
        print("[ab] " + json.dumps(dict(statement=q, reps=reps, **{
            f"{s}_ms": med[q][s] for s in sides}, card=card)), flush=True)
    print("[ab] " + json.dumps(dict(statement="stream", reps=reps, **{
        f"{s}_sum_ms": sum(med[q][s] for q in stream) for s in sides}, **{
        f"{s}_geomean_ms": math.exp(statistics.fmean(
            math.log(med[q][s]) for q in stream)) for s in sides},
        card=card)), flush=True)


def sweep(torch, CK, C, name, inputs, card) -> None:
    values, slot, mask, capacity, op = inputs
    capacity, op = int(capacity), list(CK.SEG_OPS)[int(op)]
    values = values if values.numel() else None
    n = slot.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launch = CK._launcher("seg_reduce")
    want = CK.seg_reduce_plain(values, slot, mask, capacity, op)
    out = torch.empty_like(want)

    def run(plan):
        args = CK._SegArgs()
        args[:] = (0 if values is None else values.data_ptr(),
                   slot.data_ptr(), slot.element_size(), mask.data_ptr(), n,
                   capacity, CK.SEG_OPS[op], out.data_ptr(), plan[0],
                   plan[1], int(plan[2]), CK._stream(0))
        CK._raise_on(launch(args), "seg_reduce")

    chosen = CK.seg_reduce_plan(n, capacity, sms)
    plans = {chosen}
    for per_sm in (1, 2, 4, 5, 6, 8):
        plans.add((sms * per_sm, 256, False))
        if capacity <= CK.SEG_PRIVATE_SLOTS:
            plans.add((sms * per_sm, 256, True))
    for plan in sorted(plans):
        out.fill_(CK.seg_identity(op))
        run(plan)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name} plan {plan}: differs from plain")
        ms = C.call_ms(torch, {"k": lambda: run(plan)})["k"]
        print("[plan] " + json.dumps({
            "shape": name, "n": n, "capacity": capacity, "op": op,
            "count": values is None, "blocks": plan[0], "threads": plan[1],
            "privatised": plan[2], "call_ms": ms,
            "bound_ms": C.seg_bound_ms(n, capacity, slot.element_size(),
                                       values is not None),
            "chosen": plan == chosen, "card": card}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("seg_reduce_sweep: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="tpch-sf1.power,tpch-sf10.power")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--samples", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import chip_smoke as C
    from presto_tpu_torch.ops import cuda_kernels as CK

    C.SAMPLES = args.samples
    card = C.card_line()
    CK.build()
    for workload in args.workload.split(","):
        cell = workload.split(".")[0]
        client, stream, sql = open_cell(workload, args.seed)
        for q in stream:  # ingest, plan and warm every statement
            client.execute(sql[q])
        census(torch, CK, client, stream, sql, card)
        ab(torch, CK, client, stream, sql, args.reps, card)
        captured = {}
        for q in MEASURED:
            got = C.capture_seg_reduce(torch, CK,
                                       lambda: client.execute(sql[q]))
            captured.update({f"{cell}_q{q}_{k}": v
                             for k, v in sorted(got.items())})
        if args.sweep:
            for k in ("add", "count"):
                sweep(torch, CK, C, f"{cell}_q1_{k}",
                      captured[f"{cell}_q1_{k}"], card)
        del client
        for name, inputs in captured.items():
            try:
                shapes = C.measure_apart(torch, {name: ("seg_reduce",
                                                        inputs)})
            except AssertionError as e:
                print("[failed] " + json.dumps(dict(shape=name,
                                                    error=str(e)[-1500:])),
                      flush=True)
                continue
            print("[measure] " + json.dumps(dict(shapes[0], card=card)),
                  flush=True)
        del captured
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
