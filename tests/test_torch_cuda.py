"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where there is no CUDA device.  This file
imports no jax, so it also runs on a machine with the card and without
jax (``--noconftest`` skips the JAX settings of ``tests/conftest.py``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import os
import sys

import numpy as np
import pytest
import torch

from presto_tpu_torch.ops import cuda_kernels as CK
from presto_tpu_torch.ops import hashtable as HT

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import sqlite_tpcds_oracle as SO  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    CK.build()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [0, 1, 8191, 1 << 20])
def test_masked_sum_equals_plain(card, size):
    rng = np.random.default_rng(size)
    v = torch.from_numpy(rng.integers(-2**62, 2**62, size=size))
    m = torch.from_numpy(rng.random(size) < 0.4)
    before = CK.LAUNCHES["masked_sum"]
    got = CK.masked_sum(v.to(card), m.to(card))
    torch.cuda.synchronize()
    assert int(got) == int(CK.masked_sum_plain(v, m))
    assert CK.LAUNCHES["masked_sum"] == before + (size > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [500, 317, 0])
def test_sorted_probe_equals_plain(card, n_valid):
    rng = np.random.default_rng(n_valid)
    keys = np.sort(rng.integers(-10**12, 10**12, size=500))
    keys[n_valid:] = rng.integers(-10**12, 10**12, size=500 - n_valid)
    probe = np.concatenate([rng.choice(keys, 300),
                            rng.integers(-2 * 10**12, 2 * 10**12, 300),
                            [-2**63, 2**63 - 1]]).astype(np.int64)
    keys, probe = torch.from_numpy(keys), torch.from_numpy(probe)
    got = CK.sorted_probe(keys.to(card), probe.to(card),
                          torch.tensor(n_valid, device=card))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(), CK.sorted_probe_plain(keys, probe, n_valid).numpy())


def _edge_keys(rng, runs, n_valid, n=200_000):
    """200k sorted keys (random, or in runs of ~5,000 equal keys that
    cross every sample position), int64 garbage beyond ``n_valid``."""
    keys = np.sort(rng.integers(0, 40, size=n) * 1000 if runs
                   else rng.integers(-10**12, 10**12, size=n))
    keys[n_valid:] = rng.integers(-2**63, 2**63 - 1, size=n - n_valid,
                                  dtype=np.int64)
    return keys.astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("p", [1, 255, 257, 1_000_000])
@pytest.mark.parametrize("n_valid", ["0", "1", "2", "S-1", "S", "S+1",
                                     "123457", "200000"])
def test_sorted_probe_edges_equal_plain(card, runs, p, n_valid):
    """The two-level search at every edge of its sample: n_valid around
    the sample size S that the launch plan picks for P probes, probes on
    the sampled keys (and one off), int64 min/max, garbage past n_valid."""
    _, _, sample_log2 = CK.sorted_probe_plan(
        p, torch.cuda.get_device_properties(card).multi_processor_count)
    s = 1 << sample_log2
    nv = {"S-1": s - 1, "S": s, "S+1": s + 1}[n_valid] \
        if n_valid.startswith("S") else int(n_valid)
    rng = np.random.default_rng(nv * 8 + p % 7 + runs)
    keys = _edge_keys(rng, runs, nv)
    sampled = keys[((np.arange(s) + 1) * nv >> sample_log2) - 1] \
        if nv > s else keys[:nv]
    pool = np.concatenate([[-2**63, 2**63 - 1], sampled, sampled - 1,
                           sampled + 1, rng.integers(-2 * 10**12,
                                                     2 * 10**12, 4096)])
    probe = rng.choice(pool, p)
    probe[:min(p, 2)] = pool[:min(p, 2)]
    keys_t, probe_t = torch.from_numpy(keys), torch.from_numpy(probe)
    before = CK.LAUNCHES["sorted_probe"]
    got = CK.sorted_probe(keys_t.to(card), probe_t.to(card),
                          torch.tensor(nv, device=card))
    torch.cuda.synchronize()
    assert CK.LAUNCHES["sorted_probe"] == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), CK.sorted_probe_plain(keys_t, probe_t, nv).numpy())
    # the by-value form of n_valid gives the same positions
    np.testing.assert_array_equal(
        CK.sorted_probe(keys_t.to(card), probe_t.to(card), nv).cpu().numpy(),
        got.cpu().numpy())


@pytest.mark.cuda
def test_lookup_on_card_launches_sorted_probe(card):
    """A single-key lookup of a table on the card goes through the kernel
    and equals the same lookup on the CPU."""
    rng = np.random.default_rng(9)
    build = torch.from_numpy(rng.choice(10**6, 50_000, replace=False))
    probe = torch.from_numpy(rng.integers(0, 10**6, 200_000))
    mask = torch.from_numpy(rng.random(200_000) < 0.9)
    want = HT.lookup(HT.build([build], torch.ones(50_000, dtype=torch.bool),
                              HT.capacity_for(50_000)), [probe], mask)
    table = HT.build([build.to(card)],
                     torch.ones(50_000, dtype=torch.bool, device=card),
                     HT.capacity_for(50_000))
    before = CK.LAUNCHES["sorted_probe"]
    got = HT.lookup(table, [probe.to(card)], mask.to(card))
    assert CK.LAUNCHES["sorted_probe"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_probe_recorder_sees_the_main_path_launch(card):
    """A lookup on the card hands the recorder the very tensors it gave
    the kernel, once per launch."""
    rng = np.random.default_rng(11)
    build = torch.from_numpy(rng.choice(10**6, 4_000, replace=False))
    table = HT.build([build.to(card)],
                     torch.ones(4_000, dtype=torch.bool, device=card),
                     HT.capacity_for(4_000))
    probe = torch.from_numpy(rng.integers(0, 10**6, 9_000)).to(card)
    seen = []
    CK.set_probe_recorder(lambda k, p, nv: seen.append((k, p, int(nv))))
    try:
        HT.lookup(table, [probe], torch.ones(9_000, dtype=torch.bool,
                                             device=card))
    finally:
        CK.set_probe_recorder(None)
    assert len(seen) == 1
    keys, probes, nv = seen[0]
    assert keys.is_cuda and probes.shape == (9_000,) and nv == 4_000
    torch.testing.assert_close(probes, probe, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 257, 300_000])
@pytest.mark.parametrize("valid", [1.0, 0.63])
def test_sorted_probe_repeated_keys_equal_plain(card, p, valid):
    """A non-unique build as ``HT.build`` lays it out: every key repeats
    1-7 times (as ``l_orderkey`` does in lineitem), runs crossing the
    sample positions, the masked-out rows sorted to the tail as +MAX."""
    rng = np.random.default_rng(p + int(valid * 100))
    keys = np.repeat(np.arange(1, 60_001, dtype=np.int64) * 4,
                     rng.integers(1, 8, 60_000))
    n = keys.size
    nv = int(n * valid)
    keys = np.concatenate([
        keys[np.sort(rng.choice(n, nv, replace=False))],
        np.full(n - nv, 2**63 - 1, dtype=np.int64)])
    probe = rng.integers(-3, 240_010, p).astype(np.int64)
    keys_t, probe_t = torch.from_numpy(keys), torch.from_numpy(probe)
    before = CK.LAUNCHES["sorted_probe"]
    got = CK.sorted_probe(keys_t.to(card), probe_t.to(card),
                          torch.tensor(nv, device=card))
    torch.cuda.synchronize()
    assert CK.LAUNCHES["sorted_probe"] == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), CK.sorted_probe_plain(keys_t, probe_t, nv).numpy())


@pytest.mark.cuda
def test_probe_counts_repeated_build_on_card(card):
    """Match counts into a non-unique table on the card (through the
    kernel) equal the same probe on the CPU."""
    rng = np.random.default_rng(11)
    build = torch.from_numpy(np.repeat(
        rng.choice(10**6, 40_000, replace=False), rng.integers(1, 8, 40_000)))
    bmask = torch.from_numpy(rng.random(build.shape[0]) < 0.7)
    probe = torch.from_numpy(rng.integers(0, 10**6, 200_000))
    pmask = torch.from_numpy(rng.random(200_000) < 0.9)
    cap = HT.capacity_for(build.shape[0])
    want = HT.probe_counts(HT.build([build], bmask, cap), [probe], pmask)
    before = CK.LAUNCHES["sorted_probe"]
    got = HT.probe_counts(HT.build([build.to(card)], bmask.to(card), cap),
                          [probe.to(card)], pmask.to(card))
    assert CK.LAUNCHES["sorted_probe"] == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("q", [3, 4, 9, 13, 16, 21, 22])
def test_join_query_on_card_equals_cpu(card, q):
    """A join query of TPC-H at SF0.01 on the card equals the port on the
    CPU, and its joins went through the kernel."""
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.tpch.queries import QUERIES

    def cols(t):
        return {name: col.to_pylist() for name, col in t.columns.items()}

    want = cols(LocalRunner(scale_factor=0.01, device="cpu")
                .run_sql(QUERIES[q]))
    before = CK.LAUNCHES["sorted_probe"]
    got = cols(LocalRunner(scale_factor=0.01).run_sql(QUERIES[q]))
    assert CK.LAUNCHES["sorted_probe"] > before
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 13, 19, 31, 39, 75, 90, 47, 51, 67])
def test_tpcds_query_on_card_equals_cpu(card, q):
    """TPC-DS queries at SF0.02 on the card equal the port on the CPU
    (DOUBLE columns to 1e-9 relative): UNION ALL (q2, q75), DOUBLE CASE
    and casts (q31, q90), avg and stddev_samp (q13, q39), string columns
    compared (q19), six windows over string partition keys (q47), running
    ROWS frames (q51), a 9-set ROLLUP under rank (q67); their joins went
    through the kernel."""
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.tpcds import generator as G
    from presto_tpu_torch.tpcds.queries import QUERIES

    def run(device):
        r = LocalRunner(scale_factor=0.01, device=device)
        G.attach(r, 0.02)
        return r.run_sql(QUERIES[q])

    want = run("cpu")
    before = CK.LAUNCHES["sorted_probe"]
    got = run(None)
    assert CK.LAUNCHES["sorted_probe"] > before
    SO.same_table(got, want, 1e-9, f"q{q}")


@pytest.mark.cuda
def test_connect_defaults_to_the_card(card):
    from presto_tpu_torch.client.api import connect
    conn = connect()
    assert conn._runner.device.type == "cuda"
    assert conn.execute("select count(*) c from nation").fetchall() == [(25,)]


@pytest.mark.cuda
@pytest.mark.parametrize("q", [3, 10])
def test_join_through_the_server_on_card_launches_sorted_probe(card, q):
    """A TPC-H join sent over HTTP runs on a handler thread of the server,
    on the card: its rows equal the port's on the CPU rendered the same
    way, and its join went through the kernel."""
    from presto_tpu_torch.client.api import connect
    from presto_tpu_torch.client.server import HttpClient, StatementServer
    from presto_tpu_torch.tpch.queries import QUERIES

    def over_http(device):
        srv = StatementServer(connect(device=device))
        try:
            return HttpClient(srv.url).execute(QUERIES[q])
        finally:
            srv.close()

    want = over_http("cpu")
    before = CK.LAUNCHES["sorted_probe"]
    got = over_http(None)
    assert CK.LAUNCHES["sorted_probe"] > before
    assert got == want and got[1]


@pytest.mark.cuda
def test_explain_analyze_on_card_fences_every_node(card):
    """EXPLAIN ANALYZE on the card: every node carries rows and a wall
    time, the root's rows are the query's, and the self times add up to
    no more than the root's wall (each fenced by a synchronize)."""
    import re
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.tpch.queries import QUERIES
    r = LocalRunner(scale_factor=0.01)
    rows = r.run_sql(QUERIES[3]).row_count
    lines = r.run_sql("explain analyze " + QUERIES[3]).to_pydict()[
        "Query Plan"]
    nodes = [re.search(r"\{rows: (\d+), wall: ([\d.]+)ms", ln)
             for ln in lines if ln.lstrip().startswith("- ")]
    assert nodes and all(nodes)
    assert int(nodes[0].group(1)) == rows
    wall = float(next(re.match(r"analyze: ([\d.]+)ms", ln).group(1)
                      for ln in lines if ln.startswith("analyze: ")))
    assert sum(float(m.group(2)) for m in nodes) <= wall + 5e-4 * len(nodes)


def _seg_case(n, capacity, slot_dtype, seed, used=None, density=0.7):
    """int64 values over the whole range (sums wrap mod 2^64), slots in
    [0, used) or in [-3, capacity + 3), a mask of ``density`` of the
    rows."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-2**63, 2**63 - 1, size=n, dtype=np.int64)
    g = (rng.integers(0, used, size=n) if used is not None
         else rng.integers(-3, capacity + 3, size=n)).astype(slot_dtype)
    m = rng.random(n) < density
    return torch.from_numpy(v), torch.from_numpy(g), torch.from_numpy(m)


def _seg_check(card, v, g, m, capacity, want_privatised=None):
    """Every op of ``seg_reduce`` on the card equals its plain version,
    exactly; one launch each, privatised as the plan says."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = CK.seg_reduce_plan(g.shape[0], capacity, sms)
    if want_privatised is not None:
        assert plan[2] == want_privatised
    for values, op in ((v, "add"), (None, "add"), (v, "min"), (v, "max")):
        before = CK.LAUNCHES["seg_reduce"], CK.SEG_PRIVATISED
        got = CK.seg_reduce(None if values is None else values.to(card),
                            g.to(card), m.to(card), capacity, op)
        torch.cuda.synchronize()
        launched = int(g.shape[0] > 0 and capacity > 0)
        assert (CK.LAUNCHES["seg_reduce"], CK.SEG_PRIVATISED) == \
            (before[0] + launched, before[1] + launched * plan[2])
        np.testing.assert_array_equal(
            got.cpu().numpy(),
            CK.seg_reduce_plain(values, g, m, capacity, op).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("slot_dtype", [np.int32, np.int64])
def test_seg_reduce_q1_shape_equals_plain(card, slot_dtype):
    """Q1's SF1 shape: 6,002,590 rows into 6 of 64 slots (58 empty slots
    keep 0 or the int64 extreme), privatised; sums wrap mod 2^64."""
    v, g, m = _seg_case(6_002_590, 64, slot_dtype, 1, used=6, density=0.98)
    _seg_check(card, v, g, m, 64, want_privatised=True)


@pytest.mark.cuda
@pytest.mark.parametrize("slot_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_seg_reduce_privatised_limit_equals_plain(card, slot_dtype, delta):
    """``capacity`` at the privatised limit and one either side, slots
    negative and past the end among them."""
    cap = CK.SEG_PRIVATE_SLOTS + delta
    v, g, m = _seg_case(7_000_000, cap, slot_dtype, 2 + delta)
    _seg_check(card, v, g, m, cap, want_privatised=delta <= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("slot_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", ["all_masked", "all_out_of_range", "tiny",
                                  "tail", "unaligned", "global_many_slots",
                                  "few_rows_many_slots"])
def test_seg_reduce_edges_equal_plain(card, slot_dtype, case):
    """All rows masked; every slot negative or >= capacity; 1 and 37 rows
    (a partial warp step); inputs at an odd offset (the scalar loads); the
    global branch with 2^20 slots, and with more slots than rows."""
    n, cap, used, density = {
        "all_masked": (100_003, 64, 6, 0.0),
        "all_out_of_range": (100_003, 64, None, 1.0),
        "tiny": (1, 4, 4, 1.0), "tail": (37, 8, None, 0.7),
        "unaligned": (1_000_001, 64, 6, 0.9),
        "global_many_slots": (3_000_000, 1 << 20, None, 0.7),
        "few_rows_many_slots": (5_000, 100_000, None, 0.7)}[case]
    v, g, m = _seg_case(n, cap, slot_dtype, len(case), used, density)
    if case == "all_out_of_range":
        g = torch.where(g >= 0, g + cap + 3, g)
    if case == "unaligned":
        v, g, m = v[1:], g[1:], m[1:]
    _seg_check(card, v, g, m, cap)


@pytest.mark.cuda
def test_q1_on_card_equals_cpu_through_seg_reduce(card):
    """TPC-H Q1 at SF0.01 on the card equals the port on the CPU, and its
    segment reductions went through the kernel's privatised branch."""
    from presto_tpu_torch.exec.runner import LocalRunner
    from presto_tpu_torch.tpch.queries import QUERIES

    def cols(t):
        return {name: col.to_pylist() for name, col in t.columns.items()}

    want = cols(LocalRunner(scale_factor=0.01, device="cpu")
                .run_sql(QUERIES[1]))
    before = CK.LAUNCHES["seg_reduce"], CK.SEG_PRIVATISED
    got = cols(LocalRunner(scale_factor=0.01).run_sql(QUERIES[1]))
    assert CK.LAUNCHES["seg_reduce"] > before[0]
    assert CK.SEG_PRIVATISED > before[1]
    assert got == want
