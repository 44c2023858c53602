"""Rank-side jobs of the port's multi-rank tests (no test of its own).

Each function here runs on every rank of a world started by
``presto_tpu_torch.parallel.multihost.launch_world`` (as a ``call`` job of
``python -m presto_tpu_torch.parallel.worker --spec``) and returns plain
values; the worker gathers every rank's return.  It imports torch, numpy
and the port only, never jax: the JAX side of each comparison runs in the
test process.

The seeded rows are global arrays; rank r holds the r-th contiguous block,
as ``shard_map`` with ``P("d")`` gives device r its block.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from presto_tpu_torch.data import types as T
from presto_tpu_torch.data.column import PLAIN
from presto_tpu_torch.exec import physical as PH
from presto_tpu_torch.exec.columns import Chunk, DCol
from presto_tpu_torch.exec.plan import AggSpec, PhysHashAggregate, PhysHashJoin
from presto_tpu_torch.ops.hashing import hash_keys
from presto_tpu_torch.parallel import distributed as D
from presto_tpu_torch.sql import ir

N = 8192          # probe rows (global), as tests/test_skew.py
NDV = 1000        # distinct keys
HEAVY_KEY = 7     # one key owns half of the probe rows
FANOUT = 3        # build rows per key of the expanding join


def exchange_rows(seed: int, n: int, heavy: bool):
    """(keys, values, mask) of ``n`` seeded global rows: keys in [0, 100),
    half of them one key when ``heavy``; a value is its global row index;
    about a tenth of the rows masked out."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 100, n).astype(np.int64)
    if heavy:
        keys[rng.random(n) < 0.5] = HEAVY_KEY
    mask = rng.random(n) < 0.9
    return keys, np.arange(n, dtype=np.int64), mask


def skew_rows(expanding: bool):
    """tests/test_skew.py's fixtures: probe keys and payloads, and a build
    side padded to N rows (its keys spread at a stride), unique or with
    FANOUT rows per key."""
    rng = np.random.default_rng(43 if expanding else 42)
    keys = rng.integers(0, NDV, size=N).astype(np.int64)
    keys[rng.random(N) < 0.5] = HEAVY_KEY
    pay = np.arange(N, dtype=np.int64)
    nb = NDV * (FANOUT if expanding else 1)
    bk = (np.repeat(np.arange(NDV, dtype=np.int64), FANOUT) if expanding
          else np.arange(NDV, dtype=np.int64))
    bp = np.arange(nb, dtype=np.int64) if expanding else bk * 10
    bk_pad, bp_pad = np.zeros(N, np.int64), np.zeros(N, np.int64)
    bm = np.zeros(N, bool)
    idx = np.arange(nb) * (N // nb)
    bk_pad[idx], bp_pad[idx], bm[idx] = bk, bp, True
    return keys, pay, bk_pad, bp_pad, bm


def _ctx(env) -> D.DistContext:
    return D.DistContext(None, mesh=env.mesh)


def _block(env, *arrays):
    """This rank's contiguous block of each global array, as tensors."""
    m = env.mesh
    n = arrays[0].shape[0] // m.world
    return [torch.from_numpy(a[m.rank * n:(m.rank + 1) * n].copy()).to(
        env.device) for a in arrays]


def _kv(chunk: Chunk, *names):
    cols = [chunk.cols[n].values[chunk.mask].tolist() for n in names]
    return sorted(zip(*cols))


def exchanges(env, seed: int, n: int, heavy: bool, limit: int) -> dict:
    """``repartition`` by the key (the rows this rank receives),
    ``detect_heavy_hashes`` of the key hashes, which rows survive
    ``sharded_limit``, and which rows of the whole (replicated) input
    ``deflate_chunk`` and ``block_deflate_chunk`` keep here."""
    ctx = _ctx(env)
    k, v, m = _block(env, *exchange_rows(seed, n, heavy))
    chunk = Chunk({"k": DCol(T.BIGINT, PLAIN, k),
                   "v": DCol(T.BIGINT, PLAIN, v)}, m)
    got = D.repartition(ctx, chunk, [k])
    heavy_h = D.detect_heavy_hashes(ctx, hash_keys([k]), m)
    kept = D.sharded_limit(ctx, chunk, limit)
    # the whole rows on every rank (a replicated chunk), deflated both ways
    kw, vw, mw = (torch.from_numpy(a).to(env.device)
                  for a in exchange_rows(seed, n, heavy))
    whole = Chunk({"v": DCol(T.BIGINT, PLAIN, vw)}, mw)
    return {"received": _kv(got, "k", "v"), "heavy": heavy_h.tolist(),
            "limited": chunk.cols["v"].values[kept.mask].tolist(),
            "deflated": vw[D.deflate_chunk(ctx, whole).mask].tolist(),
            "blocks": vw[D.block_deflate_chunk(ctx, whole).mask].tolist()}


def _skew_plan(expanding: bool) -> PhysHashJoin:
    kref = ir.ColumnRef("k", T.BIGINT)
    return PhysHashJoin(
        probe=None, build=None, probe_keys=(kref,), build_keys=(kref,),
        kind="inner", unique_build=not expanding,
        build_payload=(("p", "p"),),
        build_est=float(NDV * (FANOUT if expanding else 1)),
        probe_est=float(N), dist_type="partitioned")


def skew_join(env, expanding: bool) -> dict:
    """The PARTITIONED exchange of ``_exchange_join_inputs`` over the skewed
    rows, then this rank's join: the probe rows it received, the joined
    (probe payload, build payload) pairs, the heavy hashes, and the probe
    rows plain hash routing would have sent here."""
    ctx = D.DistContext(None, mesh=env.mesh)
    pk, pv, bk, bp, bm = _block(env, *skew_rows(expanding))
    probe = Chunk({"k": DCol(T.BIGINT, PLAIN, pk),
                   "v": DCol(T.BIGINT, PLAIN, pv)},
                  torch.ones(pk.shape, dtype=torch.bool, device=pk.device))
    build = Chunk({"k": DCol(T.BIGINT, PLAIN, bk),
                   "p": DCol(T.BIGINT, PLAIN, bp)}, bm)
    plan = _skew_plan(expanding)
    plain = D.repartition(ctx, probe, [pk])
    probe2, build2, _ = D._exchange_join_inputs(ctx, plan, probe, False,
                                                build, False)
    out = PH._join_core(plan, probe2, build2, ctx)
    return {"received": int(probe2.mask.sum()),
            "plain_received": int(plain.mask.sum()),
            "pairs": _kv(out, "v", "p"),
            "heavy": D.detect_heavy_hashes(
                ctx, hash_keys([pk]), probe.mask).tolist()}


def uniform_heavy(env, seed: int) -> list:
    """``detect_heavy_hashes`` over N uniform keys in [0, NDV)."""
    rng = np.random.default_rng(seed)
    (k,) = _block(env, rng.integers(0, NDV, size=N).astype(np.int64))
    ok = torch.ones(k.shape, dtype=torch.bool, device=k.device)
    return D.detect_heavy_hashes(_ctx(env), hash_keys([k]), ok).tolist()


class _Sketched:
    """Within it, every grouped approx_percentile of this rank takes the
    bottom-k sketch: the whole-group threshold is raised past any group
    count, the sample size is ``k`` when given, and ``merges`` counts the
    sample merges run (``distributed._merge_sample``)."""

    def __init__(self, k=None):
        self.k, self.merges = k, 0

    def __enter__(self):
        self.saved = D._QSKETCH_MAX_NDV, D.Q.k_for, D._merge_sample
        merge = self.saved[2]

        def counted(*a, **kw):
            self.merges += 1
            return merge(*a, **kw)
        D._QSKETCH_MAX_NDV, D._merge_sample = 1 << 62, counted
        if self.k:
            D.Q.k_for = lambda capacity: self.k
        return self

    def __exit__(self, *exc):
        D._QSKETCH_MAX_NDV, D.Q.k_for, D._merge_sample = self.saved


def sketch(env, sql: str, k=None) -> dict:
    """``sql`` with every grouped approx_percentile on the bottom-k sketch
    (``_Sketched``): its values and the sample merges this rank ran."""
    from presto_tpu_torch.parallel.worker import table_values
    with _Sketched(k) as sk:
        values = table_values(env.runner("part").run_sql(sql))
    return {"values": values, "merges": sk.merges}


SKETCH_N = 8192    # global rows of the sketch merge
SKETCH_Q = (0.5, 0.9)


def sketch_rows(seed: int):
    """(group, DOUBLE value, BIGINT value, mask) of SKETCH_N seeded rows:
    group 0 holds about 40 % of them, group 1 about 20 %, and 200 small
    groups share the rest (about 16 rows each), so a small k samples the
    two large groups while the small ones, spread over every rank, are
    kept whole; a tenth of the rows masked out."""
    rng = np.random.default_rng(seed)
    u = rng.random(SKETCH_N)
    g = np.where(u < 0.4, 0, np.where(u < 0.6, 1,
                                      2 + rng.integers(0, 200, SKETCH_N)))
    x = np.round(rng.normal(1000.0, 300.0, SKETCH_N), 2)
    y = rng.integers(-500, 500, SKETCH_N).astype(np.int64)
    return g.astype(np.int64), x, y, rng.random(SKETCH_N) < 0.9


def sketch_merge(env, seed: int, k: int) -> list:
    """The grouped PARTIAL → route → FINAL of ``approx_percentile`` over
    this rank's block of ``sketch_rows`` at sample size ``k``: the rows
    (group, estimate of x, estimate of y) this rank finalizes, and the
    sample merges it ran."""
    ctx = _ctx(env)
    g, x, y, m = _block(env, *sketch_rows(seed))
    chunk = Chunk({"g": DCol(T.BIGINT, PLAIN, g),
                   "x": DCol(T.DOUBLE, PLAIN, x),
                   "y": DCol(T.BIGINT, PLAIN, y)}, m)
    aggs = tuple(
        AggSpec(f"{c}{i}", "approx_percentile",
                   ir.ColumnRef(c, t), param=q)
        for c, t in (("x", T.DOUBLE), ("y", T.BIGINT))
        for i, q in enumerate(SKETCH_Q))
    plan = PhysHashAggregate(None, (("g", ir.ColumnRef("g", T.BIGINT)),),
                             aggs, ndv_hint=256)
    with _Sketched(k) as sk:
        out = D._partial_final(plan, chunk, ctx)
    names = ["g"] + [a.name for a in aggs]
    return [_kv(out, *names), sk.merges]


def shard_cache(env, statements) -> list:
    """A fresh runner's (ingest slices, pool bytes) after each statement."""
    r = D.DistributedRunner(env.sf, device=env.device)
    out = []
    for sql in statements:
        r.run_sql(sql)
        out.append([r.ingest_slices, r.pool.used])
    return out


def bounded_ingest(env, slice_rows: int) -> list:
    """(count of orders, this rank's ingest slices) of a fresh runner whose
    ingest is bounded to ``slice_rows`` split units."""
    r = D.DistributedRunner(env.sf, device=env.device,
                            ingest_slice_rows=slice_rows)
    t = r.run_sql("select count(*) c from orders")
    return [t.columns["c"].to_pylist()[0], r.ingest_slices]


def fail_on(env, rank: int) -> None:
    """Raise on ``rank``; every other rank waits in a barrier (and would
    wait there until its process group's timeout)."""
    if env.mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()


def stall(env, rank: int, seconds: float) -> None:
    """``rank`` sleeps ``seconds`` while every other rank waits for it in
    a barrier."""
    import time
    if env.mesh.rank == rank:
        time.sleep(seconds)
    dist.barrier()


def shared_root(tmp_path_factory):
    """A directory every xdist worker of this test run shares (the
    workers' common base), made once."""
    import os
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent / f"torch-worlds-{uid}" if uid else base / "worlds"
    root.mkdir(exist_ok=True)
    return root


def cached_world(root, name: str, world: int, spec: dict,
                 deadline_s: float = 150.0) -> dict:
    """Rank 0's results of one world of CPU ranks running the worker's
    job list ``spec``, run once per test session: the first test process
    to ask runs it under a file lock in ``root`` (a directory every xdist
    worker shares) and leaves the JSON there; the others wait on the lock
    and read it.  A world that failed is not run again: its error is left
    beside the JSON and raised to every later caller."""
    import fcntl
    import json
    import os

    from presto_tpu_torch.parallel.multihost import WorldFailed, launch_world
    out = os.path.join(str(root), f"{name}.json")
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out + ".failed"):
            with open(out + ".failed") as f:
                raise WorldFailed(f.read())
        if not os.path.exists(out):
            try:
                data = launch_world(world, spec, deadline_s, device="cpu")
            except WorldFailed as e:
                with open(out + ".failed", "w") as f:
                    f.write(str(e))
                raise
            with open(out + ".tmp", "w") as f:
                json.dump(data, f)
            os.replace(out + ".tmp", out)
    with open(out) as f:
        return json.load(f)
