"""One rank of a multi-process world: ``python -m presto_tpu_torch.parallel.worker``.

The port's counterpart of ``tools/multihost_worker.py`` (the reference's
``DistributedQueryRunner.java:72`` boots N servers in one JVM; here N OS
processes each run the same statements, SPMD).  Every rank joins the
world (``multihost.init_multihost``; NCCL on a card, gloo on the CPU),
builds its ``DistributedRunner``s and runs the same jobs in the same
order; rank 0 writes the results as JSON.  ``multihost.launch_world``
starts a world of these from a job list, guards it and returns rank 0's
results; by hand, one process per rank:

    python -m presto_tpu_torch.parallel.worker --rank K --world N \\
        --coordinator tcp://127.0.0.1:PORT --device cpu \\
        --spec jobs.json --out results.json

The job list (``--spec``) is JSON: ``{"sf": scale factor (0.01),
"runners": {name: DistributedRunner keyword arguments}, "jobs": [{"name",
"sql", "runner", "runs", "catch"} or {"name", "call": "module:function",
"args"}]}``.  A statement job runs ``sql`` ``runs`` times (the first one
warms up) on the named runner (``"default"``) and records its values,
times and exchange costs; with ``catch`` an error is recorded instead of
raised.  A ``call`` job runs ``function(env, **args)`` on every rank
(``env`` has the mesh and ``env.runner(name)``) and records every rank's
return value.  Each statement also records the CUDA kernels' launches
(none on the CPU, where the wrappers take their plain versions).  With
``"tables": true`` in the spec, rank 0 also pickles each statement job's
host ``Table`` (or the error it caught) by name beside its JSON
(``--out`` + ``.tables``), so that a caller gets typed values back.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pickle
import sys
import time


def plain(v):
    """A result value as JSON keeps it: a MAP as its [key, value] pairs
    sorted by key, an ARRAY as a list, a number, string, bool or NULL as
    itself, anything else as its ``str``."""
    if isinstance(v, dict):
        return sorted(([plain(k), plain(x)] for k, x in v.items()),
                      key=lambda kv: repr(kv[0]))
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def table_values(table) -> dict:
    """{column: [plain values]} of a host ``Table``."""
    return {n: [plain(v) for v in c.to_pylist()]
            for n, c in table.columns.items()}


class Env:
    """What a ``call`` job gets: the rank's mesh, its device and scale,
    and the spec's runners by name (built on first use)."""

    def __init__(self, sf: float, device, runners: dict):
        from .distributed import make_mesh
        self.sf = sf
        self.mesh = make_mesh(device)
        self.device = self.mesh.device
        self._kwargs = runners
        self._runners: dict = {}

    def runner(self, name: str = "default"):
        from .distributed import DistributedRunner
        if name not in self._runners:
            self._runners[name] = DistributedRunner(
                self.sf, device=self.device, **self._kwargs.get(name, {}))
        return self._runners[name]


def _launches():
    from ..ops import cuda_kernels as CK
    return dict(CK.LAUNCHES)


def _portable(e: Exception) -> Exception:
    """``e`` if it survives pickling, else a RuntimeError naming it."""
    try:
        pickle.loads(pickle.dumps(e))
        return e
    except Exception:  # noqa: BLE001 -- any pickling failure
        return RuntimeError(f"{type(e).__name__}: {e}")


def _sql_job(env: Env, job: dict, typed: dict) -> dict:
    import torch
    cuda = env.device.type == "cuda"
    runner = env.runner(job.get("runner", "default"))
    before = _launches()
    t0 = time.perf_counter()
    try:
        first = runner.run_sql(job["sql"])
    except Exception as e:  # noqa: BLE001 -- recorded, the job asked
        if not job.get("catch"):
            raise
        typed[job["name"]] = _portable(e)
        return {"name": job["name"], "error": f"{type(e).__name__}: {e}"}
    typed[job["name"]] = first
    first_s = time.perf_counter() - t0
    values = table_values(first)
    equal, warm = True, []
    for _ in range(max(job.get("runs", 1) - 1, 0)):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = runner.run_sql(job["sql"])
        if cuda:
            torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
        equal = equal and table_values(again) == values
    rec = {"name": job["name"], "columns": list(first.names),
           "rows": first.row_count, "values": values, "runs_equal": equal,
           "first_run_s": first_s, "warm_ms": warm,
           "host_syncs": runner.last_host_syncs,
           "collectives": runner.last_collectives,
           "bytes_exchanged": runner.last_bytes_exchanged,
           "build_rows": runner.last_trace_stats["build_rows"],
           "ingest_slices": runner.ingest_slices,
           "pool_used": runner.pool.used}
    after = _launches()
    rec["launches"] = {k: after[k] - before[k] for k in after}
    return rec


def _call_job(env: Env, job: dict) -> dict:
    import torch.distributed as dist
    module, fn = job["call"].split(":")
    got = getattr(importlib.import_module(module), fn)(
        env, **job.get("args", {}))
    every = [None] * env.mesh.world
    dist.all_gather_object(every, got)
    return {"name": job["name"], "ranks": every}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--coordinator", required=True,
                    help="tcp://host:port or file://path")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds any collective may wait")
    ap.add_argument("--device", default=None,
                    help="cpu, or this rank's card (default cuda:LOCAL_RANK)")
    ap.add_argument("--spec", required=True, help="the JSON job list")
    ap.add_argument("--out", default=None, help="rank 0 writes JSON here")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .multihost import init_multihost
    torch.set_num_threads(1)  # one rank per core
    init_multihost(args.rank, args.world, args.coordinator,
                   timeout_s=args.timeout, device=args.device)
    with open(args.spec) as f:
        spec = json.load(f)
    sf = spec.get("sf", 0.01)
    env = Env(sf, args.device, spec.get("runners", {}))
    from ..ops import cuda_kernels as CK
    if env.device.type == "cuda":
        CK.build()
    CK.reset_launches()
    t0 = time.perf_counter()
    typed: dict = {}
    results = [_call_job(env, job) if "call" in job
               else _sql_job(env, job, typed) for job in spec["jobs"]]
    out = {"world": args.world, "backend": dist.get_backend(),
           "device": str(env.device), "sf": sf,
           "seconds": time.perf_counter() - t0, "results": results,
           "launches": _launches()}
    for rec in results:
        print(f"[{args.rank}] {rec['name']}: "
              f"{rec.get('rows', rec.get('error', 'call'))}", flush=True)
    if args.rank == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
        if spec.get("tables"):
            with open(args.out + ".tables", "wb") as f:
                pickle.dump(typed, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
