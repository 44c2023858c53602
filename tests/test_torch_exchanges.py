"""The port's exchanges and bottom-k sketch held to the JAX package's.

- ``repartition``, ``detect_heavy_hashes``, ``sharded_limit``,
  ``deflate_chunk`` and ``block_deflate_chunk`` of
  ``presto_tpu_torch/parallel/distributed.py`` on 4 CPU ranks (gloo, one
  process each, ``tests/torch_dist_ranks.py``) against the JAX functions
  under ``shard_map`` on 4 of the conftest's virtual devices, the same
  seeded numpy rows on each rank and device (rank r holds the r-th block):
  the rows each destination receives as a multiset, the heavy hashes
  exactly, the rows that survive the limit.
- ``tests/test_skew.py``'s claims through the port: the heavy key found,
  rows balanced, skewed unique and expanding joins correct, uniform keys
  finding nothing.  Its "plain FIXED_HASH overflows on skew" has no
  counterpart: the port's exchanges move exact sizes and cannot overflow,
  so the test asserts the imbalance that plain routing leaves (one rank
  receiving more than half the rows) and the balance of the skew-aware
  route instead.
- ``ops/quantile.py`` bit for bit against ``presto_tpu/ops/quantile.py``,
  and the sketch's merge across 4 ranks (grouped PARTIAL → route → FINAL
  at a small k) against the bottom-k of the union of every rank's rows,
  computed here in numpy: each estimate exactly.
- The guard against hung worlds: a world whose rank raises fails within
  its deadline, the rank's traceback in the error.
"""

import time
from collections import Counter

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from presto_tpu_torch.parallel.multihost import WorldFailed, launch_world

ND = 4
SKETCH_SEED, SKETCH_K = 5, 64
SEEDS = {"uniform": (0, 1024, False, 100), "heavy": (1, 8192, True, 3000)}

SPEC = {"runners": {}, "jobs": (
    [{"name": f"x_{k}", "call": "tests.torch_dist_ranks:exchanges",
      "args": dict(zip(("seed", "n", "heavy", "limit"), v))}
     for k, v in SEEDS.items()]
    + [{"name": f"skew_{e}", "call": "tests.torch_dist_ranks:skew_join",
        "args": {"expanding": e}} for e in (False, True)]
    + [{"name": "uniform", "call": "tests.torch_dist_ranks:uniform_heavy",
        "args": {"seed": 7}},
       {"name": "sketch_merge", "call": "tests.torch_dist_ranks:sketch_merge",
        "args": {"seed": SKETCH_SEED, "k": SKETCH_K}}])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def world_root(tmp_path_factory):
    return R.shared_root(tmp_path_factory)


@pytest.fixture
def ranks(world_root):
    data = R.cached_world(world_root, "exchanges4", ND, SPEC)
    return {r["name"]: r["ranks"] for r in data["results"]}


def _jax_exchanges(seed, n, heavy, limit):
    """The JAX functions over the same rows: per device, the received
    (key, value) rows, the heavy hashes, the values surviving the limit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from presto_tpu.data import types as T
    from presto_tpu.data.column import PLAIN
    from presto_tpu.exec.columns import Chunk, DCol
    from presto_tpu.ops.hashing import hash_keys
    from presto_tpu.parallel import distributed as D

    mesh = D.make_mesh(ND)
    keys, vals, mask = R.exchange_rows(seed, n, heavy)
    sh = NamedSharding(mesh, P("d"))
    put = [jax.device_put(a, sh) for a in (keys, vals, mask)]
    shard_map, no_check = D._get_shard_map()

    def stage(k, v, m):
        chunk = Chunk({"k": DCol(T.BIGINT, PLAIN, k),
                       "v": DCol(T.BIGINT, PLAIN, v)}, m)
        out, ovf = D.repartition(chunk, [k], slack=8)
        heavy_h = D.detect_heavy_hashes(hash_keys([k]), m)
        kept = D.sharded_limit(chunk, limit)
        return (jnp.where(out.mask, out.cols["k"].values, -1),
                out.cols["v"].values, ovf[None], heavy_h[None],
                jnp.where(kept.mask, v, -1))

    def replicated(v, m):
        chunk = Chunk({"v": DCol(T.BIGINT, PLAIN, v)}, m)
        return (jnp.where(D.deflate_chunk(chunk).mask, v, -1),
                jnp.where(D.block_deflate_chunk(chunk).mask, v, -1))

    fn = jax.jit(shard_map(stage, mesh=mesh, in_specs=(P("d"),) * 3,
                           out_specs=(P("d"),) * 5, **no_check))
    kk, vv, ovf, hh, lim = (np.asarray(x) for x in fn(*put))
    rep = jax.jit(shard_map(replicated, mesh=mesh, in_specs=(P(), P()),
                            out_specs=(P("d"), P("d")), **no_check))
    defl, blocks = (np.asarray(x).reshape(ND, -1)
                    for x in rep(jnp.asarray(vals), jnp.asarray(mask)))
    assert not ovf.any(), "the JAX route overflowed its buckets"
    kk, vv = kk.reshape(ND, -1), vv.reshape(ND, -1)
    received = [sorted((int(a), int(b)) for a, b in zip(kk[d], vv[d])
                       if a >= 0) for d in range(ND)]
    lim = lim.reshape(ND, -1)
    limited = [[int(x) for x in lim[d] if x >= 0] for d in range(ND)]
    kept = {"deflated": defl, "blocks": blocks}
    kept = {k: [[int(x) for x in v[d] if x >= 0] for d in range(ND)]
            for k, v in kept.items()}
    return received, [[int(x) for x in h] for h in hh], limited, kept


@pytest.mark.parametrize("case", sorted(SEEDS))
def test_exchanges_equal_jax(case, ranks):
    """Every destination receives the JAX device's rows; the heavy hashes,
    the limit's survivors and the rows each deflation keeps are the JAX
    package's."""
    port = ranks[f"x_{case}"]
    received, heavy, limited, kept = _jax_exchanges(*SEEDS[case])
    for d in range(ND):
        assert [tuple(r) for r in port[d]["received"]] == received[d], d
        assert port[d]["heavy"] == heavy[d], d
        assert port[d]["limited"] == limited[d], d
        for how in ("deflated", "blocks"):
            assert port[d][how] == kept[how][d], (how, d)
    # block deflation: the rank-major concatenation is the input's order
    live = [int(v) for v, m in zip(*R.exchange_rows(*SEEDS[case][:3])[1:])
            if m]
    assert [v for d in range(ND) for v in port[d]["blocks"]] == live
    keys = R.exchange_rows(*SEEDS[case][:3])[0]
    if case == "heavy":  # the heavy key's hash is found
        from presto_tpu_torch.ops.hashing import hash_keys
        h = int(hash_keys([torch.tensor([R.HEAVY_KEY])])[0])
        assert h in port[0]["heavy"] and np.mean(keys == R.HEAVY_KEY) > .4


def test_skew_plain_routing_unbalanced(ranks):
    """The counterpart of ``test_plain_repartition_overflows_on_skew``:
    plain hash routing sends the heavy key's half of the rows to one
    rank (the JAX package's buckets overflow there)."""
    plain = [r["plain_received"] for r in ranks["skew_False"]]
    assert sum(plain) == R.N and max(plain) > R.N // 2


@pytest.mark.parametrize("expanding", [False, True])
def test_skew_exchange_balances_and_joins_correctly(expanding, ranks):
    """Heavy probe rows split round-robin, their build rows on every rank:
    each rank receives between half and twice its fair share, and the
    join's pairs are exactly every probe row with each build row of its
    key (unique build: ``key * 10``; expanding: FANOUT rows a key)."""
    per = ranks[f"skew_{expanding}"]
    got = [r["received"] for r in per]
    fair = R.N / ND
    assert sum(got) == R.N
    assert max(got) <= 2 * fair and min(got) >= fair / 2, got
    keys, pay, bk, bp, bm = R.skew_rows(expanding)
    by_key = {}
    for k, p in zip(bk[bm], bp[bm]):
        by_key.setdefault(int(k), []).append(int(p))
    want = Counter((int(v), p) for v, k in zip(pay, keys)
                   for p in by_key[int(k)])
    assert Counter(tuple(x) for r in per for x in r["pairs"]) == want


def test_heavy_detection_identifies_hot_hash(ranks):
    """The heavy key's hash is found, the same on every rank, and nothing
    near the uniform keys' share (at most 2 hashes)."""
    from presto_tpu_torch.ops.hashing import hash_keys
    heavy = [r["heavy"] for r in ranks["skew_False"]]
    assert all(h == heavy[0] for h in heavy)
    hk = int(hash_keys([torch.tensor([R.HEAVY_KEY])])[0])
    assert hk in heavy[0]
    real = [h for h in heavy[0] if h != 0xFFFFFFFF]
    assert len(real) <= 2, heavy[0]


def test_uniform_keys_detect_nothing(ranks):
    assert all(h == [0xFFFFFFFF] * 8 for h in ranks["uniform"])


# ---- ops/quantile.py bit for bit

def _quantile_inputs(floating: bool, n=3000, capacity=64, seed=5):
    rng = np.random.default_rng(seed)
    vals = (rng.normal(0, 1e6, n) if floating
            else rng.integers(-10**12, 10**12, n)).astype(
        np.float64 if floating else np.int64)
    vals[rng.random(n) < 0.05] = vals[0]  # repeated values
    slot = rng.integers(-1, capacity, n).astype(np.int32)
    mask = rng.random(n) < 0.9
    return vals, slot, mask, capacity


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("floating", [False, True])
@pytest.mark.parametrize("k", [4, 256])
def test_quantile_equals_jax(floating, k):
    """``group_state``, ``merge_states`` (two partial states merged) and
    ``estimate`` equal the JAX module's, bit for bit (k=4 keeps a sample
    smaller than most groups, k=256 takes them whole)."""
    import jax
    import jax.numpy as jnp
    from presto_tpu.ops import quantile as JQ
    from presto_tpu_torch.ops import quantile as Q

    # each JAX function compiled whole (op by op it compiles ~100 ops)
    group_state = jax.jit(JQ.group_state, static_argnums=(3, 4))
    merge_states = jax.jit(JQ.merge_states, static_argnums=(5,))
    estimate = jax.jit(JQ.estimate, static_argnums=(3,))

    vals, slot, mask, cap = _quantile_inputs(floating)
    assert Q.k_for(cap) == JQ.k_for(cap) and Q.k_for(10**6) == JQ.k_for(10**6)
    half = vals.shape[0] // 2
    states = []
    for lo, hi in ((0, half), (half, vals.shape[0])):
        t = Q.group_state(torch.from_numpy(vals[lo:hi]),
                          torch.from_numpy(slot[lo:hi]),
                          torch.from_numpy(mask[lo:hi]), cap, k)
        j = group_state(jnp.asarray(vals[lo:hi]), jnp.asarray(slot[lo:hi]),
                        jnp.asarray(mask[lo:hi]), cap, k)
        for a, b in zip(t, j):
            assert np.array_equal(_bits(a.numpy()), _bits(b))
        states.append([x.numpy() for x in t])
    cat = [np.concatenate(p) for p in zip(*states)]
    rows = np.concatenate([np.arange(cap)] * 2).astype(np.int32)
    live = cat[2] > 0
    t = Q.merge_states(*(torch.from_numpy(x) for x in cat),
                       torch.from_numpy(rows), torch.from_numpy(live), cap)
    j = merge_states(*(jnp.asarray(x) for x in cat), jnp.asarray(rows),
                     jnp.asarray(live), cap)
    for a, b in zip(t, j):
        assert np.array_equal(_bits(a.numpy()), _bits(b))
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        te = Q.estimate(*t, q)
        je = estimate(*j, q)
        for a, b in zip(te, je):
            assert np.array_equal(_bits(a.numpy()), _bits(b))


def _sketch_oracle(seed: int, k: int) -> dict:
    """{(group, aggregate): estimate} of ``torch_dist_ranks.sketch_merge``
    from its definition: a row's priority hashes its value bits and its
    index in its rank's block; a group's sample is the k live rows of
    smallest priority over every rank; the estimate is the nearest rank
    ceil(q n) of the sorted sample, n = min(group rows, k)."""
    from presto_tpu_torch.ops.hashing import hash_keys
    g, x, y, m = R.sketch_rows(seed)
    local = np.tile(np.arange(R.SKETCH_N // ND, dtype=np.int64), ND)
    want = {}
    for col, vals in (("x", x), ("y", y)):
        bits = vals.view(np.int64) if vals.dtype == np.float64 else vals
        prio = hash_keys([torch.from_numpy(bits.copy()),
                          torch.from_numpy(local)]).numpy()
        for grp in np.unique(g[m]):
            sel = m & (g == grp)
            first = np.argsort(prio[sel], kind="stable")[:k]
            sample = np.sort(vals[sel][first])
            n = min(int(sel.sum()), k)
            for i, q in enumerate(R.SKETCH_Q):
                want[(int(grp), f"{col}{i}")] = sample[
                    max(int(np.ceil(q * n)) - 1, 0)].item()
    return want


def test_sketch_merge_equals_bottom_k_of_the_union(ranks):
    """approx_percentile's sample state crosses the exchange and merges:
    every estimate equals the bottom-k of the union of all ranks' rows,
    on the two groups larger than k (sampled) and on the 200 small ones
    spread over the ranks (kept whole, so each is the exact nearest rank
    only when the merge sums every rank's count)."""
    g, _, _, m = R.sketch_rows(SKETCH_SEED)
    assert min(int((m & (g == grp)).sum()) for grp in (0, 1)) > 8 * SKETCH_K
    assert all(merges > 0 for _, merges in ranks["sketch_merge"])
    rows = [r for got, _ in ranks["sketch_merge"] for r in got]
    aggs = [f"{c}{i}" for c in "xy" for i in range(len(R.SKETCH_Q))]
    got = {(r[0], a): v for r in rows for a, v in zip(aggs, r[1:])}
    assert len(rows) == len({r[0] for r in rows})  # one owner per group
    want = _sketch_oracle(SKETCH_SEED, SKETCH_K)
    bad = [(key, got.get(key), v) for key, v in want.items()
           if got.get(key) != v]
    assert len(got) == len(want) and not bad, (len(got), len(want), bad[:5])


# ---- the guard against hung worlds

def test_failing_rank_fails_the_world_within_its_deadline():
    """Rank 1 raises while rank 0 waits in a collective: the launcher
    kills the world as soon as rank 1 exits, well inside the deadline,
    and the error carries rank 1's traceback."""
    spec = {"jobs": [{"name": "fail", "call": "tests.torch_dist_ranks:fail_on",
                      "args": {"rank": 1}}]}
    t0 = time.monotonic()
    with pytest.raises(WorldFailed, match="rank 1 fails on purpose"):
        launch_world(2, spec, deadline_s=120, device="cpu")
    assert time.monotonic() - t0 < 60


def test_world_past_its_deadline_is_killed():
    """A world that outlives its deadline is killed, not waited for."""
    spec = {"jobs": [{"name": "stall", "call": "tests.torch_dist_ranks:stall",
                      "args": {"rank": 1, "seconds": 300}}]}
    t0 = time.monotonic()
    with pytest.raises(WorldFailed, match="deadline"):
        launch_world(2, spec, deadline_s=5, device="cpu", timeout_s=60)
    assert time.monotonic() - t0 < 15
