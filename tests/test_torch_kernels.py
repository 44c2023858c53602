"""The torch port's kernel modules against the JAX package, exactly.

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU each kernel wrapper of ``presto_tpu_torch.ops.cuda_kernels`` takes
its plain PyTorch version; the Pallas kernels run in interpret mode.  Every
comparison is exact (tolerance 0): everything here is integer.
``tests/test_torch_cuda.py`` holds the CUDA kernels against their plain
versions on a card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from presto_tpu.ops import agg as JA
from presto_tpu.ops import hashtable as JHT
from presto_tpu.ops import int128 as JI
from presto_tpu.ops import pallas_kernels as PK
from presto_tpu.ops import sort as JS
from presto_tpu_torch.ops import agg as TA
from presto_tpu_torch.ops import cuda_kernels as CK
from presto_tpu_torch.ops import decimal as TD
from presto_tpu_torch.ops import hashtable as THT
from presto_tpu_torch.ops import int128 as TI
from presto_tpu_torch.ops import sort as TS


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def n(x):
    return np.asarray(x)


@pytest.fixture
def pallas_interpret():
    PK.configure("interpret")
    yield
    PK.configure("off")


@pytest.fixture
def no_launches():
    CK.reset_launches()
    yield
    assert CK.LAUNCHES == dict.fromkeys(CK.SOURCES, 0)


# ---------------------------------------------------------------- masked_sum

@pytest.mark.parametrize("seed,density", [(0, 0.4), (1, 0.0), (2, 1.0)])
def test_masked_sum_plain_equals_pallas(seed, density, no_launches):
    """The plain version equals the Pallas kernel on its exact domain
    (|v| < 2^43; seed 0 is ``test_pallas_kernels.test_masked_sum``)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-10**9, 10**9, size=20000).astype(np.int64)
    m = rng.random(20000) < density
    want = int(PK.masked_sum(jnp.asarray(v), jnp.asarray(m), interpret=True))
    got = int(CK.masked_sum(t(v), t(m)))
    assert got == want == int(v[m].sum())


@pytest.mark.parametrize("size", [0, 1, 8191, 50000])
def test_masked_sum_wraps_like_numpy_near_2_62(size, no_launches):
    """Exact mod 2^64 where the TPU kernel's 2^43 limit does not reach."""
    rng = np.random.default_rng(size)
    v = rng.integers(-2**62, 2**62, size=size).astype(np.int64)
    m = rng.random(size) < 0.5
    with np.errstate(over="ignore"):
        want = int(np.where(m, v, 0).sum(dtype=np.int64))
    assert int(CK.masked_sum(t(v), t(m))) == want


def test_masked_sum_rejects_bad_inputs():
    with pytest.raises(ValueError):
        CK.masked_sum(torch.zeros(4, dtype=torch.int32),
                      torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        CK.masked_sum(torch.zeros(4, dtype=torch.int64),
                      torch.ones(3, dtype=torch.bool))


# ------------------------------------------------------------- sorted_probe

def _probe_case(seed, n_keys, n_valid):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(-10**12, 10**12, size=n_keys)
                   .astype(np.int64))
    # the tail beyond n_valid is garbage the search must never read
    keys[n_valid:] = rng.integers(-10**12, 10**12, size=n_keys - n_valid)
    probe = np.concatenate([
        rng.choice(keys[:max(n_valid, 1)], 150),
        rng.integers(-2 * 10**12, 2 * 10**12, 150),
        [-2**63, 2**63 - 1, -3 * 10**12, 3 * 10**12]]).astype(np.int64)
    return keys, probe


@pytest.mark.parametrize("n_keys,n_valid", [(500, 500), (500, 317),
                                            (500, 0), (1, 1)])
def test_sorted_probe_plain_equals_pallas(n_keys, n_valid, no_launches):
    """Negative keys, n_valid < cap, n_valid = 0, probes past both ends."""
    keys, probe = _probe_case(n_keys + n_valid, n_keys, n_valid)
    want = n(PK.sorted_probe(jnp.asarray(keys), jnp.asarray(probe), n_valid,
                             interpret=True))
    np.testing.assert_array_equal(
        want, np.searchsorted(keys[:n_valid], probe, side="left"))
    got = CK.sorted_probe(t(keys), t(probe), torch.tensor(n_valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _runs_case(seed, n_keys, n_valid):
    """Keys in long runs of equal values (runs cross every sample position
    of the CUDA kernel's two-level search), garbage beyond n_valid, and
    probes on, between and beyond the runs."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(-6, 6, size=n_keys) * 1000).astype(np.int64)
    keys[n_valid:] = rng.integers(-2**63, 2**63 - 1, size=n_keys - n_valid,
                                  dtype=np.int64)
    probe = np.concatenate([
        np.arange(-7, 7) * 1000, np.arange(-7, 7) * 1000 + 1,
        rng.integers(-8000, 8000, 100),
        [-2**63, 2**63 - 1]]).astype(np.int64)
    return keys, probe


@pytest.mark.parametrize("n_valid", [255, 256, 257, 511, 512, 513, 600])
def test_sorted_probe_plain_equals_pallas_runs_of_duplicates(n_valid,
                                                              no_launches):
    """Duplicate-heavy keys with n_valid at and around powers of two."""
    keys, probe = _runs_case(n_valid, 600, n_valid)
    want = n(PK.sorted_probe(jnp.asarray(keys), jnp.asarray(probe), n_valid,
                             interpret=True))
    np.testing.assert_array_equal(
        want, np.searchsorted(keys[:n_valid], probe, side="left"))
    got = CK.sorted_probe(t(keys), t(probe), n_valid)
    np.testing.assert_array_equal(got.numpy(), want)


def _two_level_lower_bound(keys, n_valid, probe, sample_log2):
    """numpy model of the CUDA kernel's search (``csrc/sorted_probe.cu``):
    a lower bound in an evenly spaced sample, then a search of the one
    bucket that must hold the answer, reading where the probe would lie if
    the keys rose evenly (guessed in float32 from exact 64-bit
    differences) and bisecting after a read that did not halve the range."""
    size = 1 << sample_log2
    whole = n_valid <= size
    m = n_valid if whole else size

    def pos(j):
        return j if whole else (((j + 1) * n_valid) >> sample_log2) - 1

    sample = keys[[pos(j) for j in range(m)]]
    out = []
    for x in probe.tolist():
        b = int(np.searchsorted(sample, x, side="left"))
        lo = 0 if b == 0 else pos(b - 1) + 1
        hi = n_valid if b == m else pos(b)
        klo = int(sample[b - 1]) if b > 0 else 0
        khi = int(sample[b]) if b < m else 0
        bounded = 0 < b < m
        interp = bounded
        while lo < hi:
            length = hi - lo
            g = lo + (length >> 1)
            if interp:
                f = np.float32((x - klo) % 2**64) / np.float32(
                    (khi - klo) % 2**64)
                g = lo + int(min(f * np.float32(length),
                                 np.float32(length - 1)))
            v = int(keys[g])
            if v < x:
                lo, klo = g + 1, v
            else:
                hi, khi = g, v
            interp = bounded and hi - lo <= length >> 1
        out.append(lo)
    return np.array(out)


@pytest.mark.parametrize("sample_log2,n_valid", [
    (8, 0), (8, 1), (8, 2), (8, 255), (8, 256), (8, 257), (8, 600),
    (7, 127), (7, 129), (4, 600), (0, 1), (0, 2), (0, 600)])
@pytest.mark.parametrize("spread", ["runs", "int64"])
def test_two_level_search_model_equals_searchsorted(sample_log2, n_valid,
                                                    spread):
    """The bucket rule and the interpolating search stay exact under runs
    of equal keys that cross sample positions, keys over the whole int64
    range, probes equal to sampled keys and int64 extremes, and never read
    at or beyond n_valid (garbage there)."""
    keys, probe = _runs_case(7, 600, n_valid)
    if spread == "int64":
        rng = np.random.default_rng(n_valid)
        keys[:n_valid] = np.sort(rng.integers(-2**63, 2**63 - 1,
                                              size=n_valid, dtype=np.int64))
        probe = np.concatenate([probe, keys[:n_valid], keys[:n_valid] + 1,
                                rng.integers(-2**63, 2**63 - 1, size=100,
                                             dtype=np.int64)])
    size = 1 << sample_log2
    if n_valid > size:  # the sampled keys themselves, and one off
        sampled = keys[(((np.arange(size) + 1) * n_valid) >> sample_log2)
                       - 1]
        probe = np.concatenate([probe, sampled, sampled + 1])
    guarded = keys[:n_valid]  # an index at or past n_valid raises
    np.testing.assert_array_equal(
        _two_level_lower_bound(guarded, n_valid, probe, sample_log2),
        np.searchsorted(guarded, probe, side="left"))


@pytest.mark.parametrize("p", [1, 2, 127, 255, 257, 75_143, 270_335,
                               270_336, 1_000_000, 6_002_590, 2**31 - 1])
@pytest.mark.parametrize("sms", [1, 132])
def test_sorted_probe_plan_covers_every_probe(p, sms):
    blocks, threads, sample_log2 = CK.sorted_probe_plan(p, sms)
    assert CK.SAMPLE_LOG2[0] <= sample_log2 <= CK.SAMPLE_LOG2[1]
    if p >= 2 * sms * 1024:  # persistent: one 1024-thread block per SM
        assert (blocks, threads) == (sms, 1024)
    else:  # one search a thread, every probe in the first pass
        assert threads == 128
        assert blocks * threads >= p > (blocks - 1) * threads
    # the sample: the power of two at or below half the block's probes,
    # at most 256 keys
    per_block = -(-p // blocks)
    assert (1 << sample_log2) <= max(per_block // 2, 1)
    assert sample_log2 == CK.SAMPLE_LOG2[1] == 8 or \
        per_block < 4 << sample_log2


def test_sorted_probe_n_valid_forms_on_the_host():
    """An int or a CPU tensor is passed by value; a tensor of several
    elements is refused; all forms give the same positions."""
    assert CK._n_valid_arg(317, 0) == (None, 0, 317)
    assert CK._n_valid_arg(torch.tensor(317), 0) == (None, 0, 317)
    assert CK._n_valid_arg(torch.tensor([317], dtype=torch.int32), 0) == \
        (None, 0, 317)
    with pytest.raises(ValueError):
        CK._n_valid_arg(torch.tensor([1, 2]), 0)
    keys, probe = _probe_case(3, 500, 317)
    want = np.searchsorted(keys[:317], probe, side="left")
    for nv in (317, torch.tensor(317), torch.tensor([317], dtype=torch.int32)):
        np.testing.assert_array_equal(
            CK.sorted_probe(t(keys), t(probe), nv).numpy(), want)


def test_probe_recorder_sees_launches_only():
    """The recorder is called where the wrapper launches its kernel, and
    nowhere else: a probe on the CPU (the plain version) records nothing."""
    seen = []
    CK.set_probe_recorder(lambda *a: seen.append(a))
    try:
        keys, probe = _probe_case(4, 300, 300)
        CK.sorted_probe(t(keys), t(probe), 300)
    finally:
        CK.set_probe_recorder(None)
    assert seen == [] and CK._probe_recorder is None


def test_sum_recorder_sees_launches_only():
    """As the probe recorder: a sum on the CPU records nothing."""
    seen = []
    CK.set_sum_recorder(lambda *a: seen.append(a))
    try:
        CK.masked_sum(torch.arange(5), torch.ones(5, dtype=torch.bool))
    finally:
        CK.set_sum_recorder(None)
    assert seen == [] and CK._sum_recorder is None


def test_chip_smoke_probe_bound_counts_a_sector_per_probe():
    """``chip_smoke.py``'s byte bound of ``sorted_probe``: probes and
    positions once, and of the keys one 32-byte sector per probe at most,
    never more than the table."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as C
    per_ms = C.HBM_BYTES_PER_S / 1e3
    assert C.probe_bound_ms(142_989, 6_002_590) * per_ms == \
        pytest.approx(12 * 142_989 + 32 * 142_989 + 8)
    assert C.probe_bound_ms(6_002_590, 1_500_000) * per_ms == \
        pytest.approx(12 * 6_002_590 + 8 * 1_500_000 + 8)
    assert C.probe_bound_ms(0, 10) * per_ms == pytest.approx(8)


@pytest.mark.parametrize("values,slot_bytes,per_row", [
    (True, 4, 13), (False, 4, 5), (True, 8, 17), (False, 8, 9)])
def test_chip_smoke_seg_bound_reads_each_row_once(values, slot_bytes,
                                                  per_row):
    """``chip_smoke.py``'s byte bound of ``seg_reduce``: each row's value
    (none for a count), slot and mask byte read once, the slots written."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as C
    per_ms = C.HBM_BYTES_PER_S / 1e3
    assert C.seg_bound_ms(59_996_324, 64, slot_bytes, values) * per_ms == \
        pytest.approx(per_row * 59_996_324 + 8 * 64)


def test_seg_reduce_rejects_bad_inputs():
    v = torch.zeros(4, dtype=torch.int64)
    g = torch.zeros(4, dtype=torch.int32)
    m = torch.ones(4, dtype=torch.bool)
    for args in ((v.to(torch.int32), g, m, 4), (v, g.to(torch.int16), m, 4),
                 (v, g, m[:3], 4), (v[:3], g, m, 4), (v, g, m.to(torch.int8), 4),
                 (v[::2], g[::2], m[::2], 4), (None, g, m, 4, "min"),
                 (v, g, m, 4, "sum")):
        with pytest.raises(ValueError):
            CK.seg_reduce(*args)
    with pytest.raises(ValueError):  # one tensor off the CPU, not on a card
        CK.seg_reduce(v, g, m.to("meta"), 4)


def test_sorted_probe_rejects_bad_inputs():
    keys = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        CK.sorted_probe(keys, torch.zeros(4, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        CK.sorted_probe(keys.reshape(2, 2), keys, 4)
    with pytest.raises(ValueError):
        CK.sorted_probe(torch.zeros(8, dtype=torch.int64)[::2], keys, 4)
    with pytest.raises(ValueError):  # one tensor off the CPU, not on a card
        CK.sorted_probe(keys, torch.zeros(4, dtype=torch.int64,
                                          device="meta"), 4)


# ---------------------------------------------------------------- hashtable

def _tables(keys_np, mask_np):
    cap = JHT.capacity_for(len(keys_np[0]))
    jt = JHT.build([jnp.asarray(k) for k in keys_np], jnp.asarray(mask_np),
                   cap)
    tt = THT.build([t(k) for k in keys_np], t(mask_np), cap)
    return jt, tt


def test_build_equals_jax():
    rng = np.random.default_rng(5)
    k = rng.integers(-50, 50, size=900).astype(np.int64)
    m = rng.random(900) < 0.8
    jt, tt = _tables([k], m)
    for f in ("owner", "slot_of_row", "counts", "offsets", "rows_csr",
              "run_of_pos", "n_valid"):
        np.testing.assert_array_equal(n(getattr(jt, f)),
                                      getattr(tt, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(n(jt.sorted_keys[0]),
                                  tt.sorted_keys[0].numpy())


@pytest.mark.parametrize("n_build,n_probe", [(700, 3000), (4000, 100)])
def test_lookup_single_key_equals_jax(n_build, n_probe, pallas_interpret,
                                      no_launches):
    """Single int64 key: JAX through the Pallas kernel (interpret), the
    port through ``sorted_probe``'s plain version."""
    rng = np.random.default_rng(n_build)
    build = rng.choice(10**5, size=n_build, replace=False).astype(np.int64)
    bmask = rng.random(n_build) < 0.9
    probe = rng.integers(0, 10**5, size=n_probe).astype(np.int64)
    pmask = rng.random(n_probe) < 0.9
    jt, tt = _tables([build], bmask)
    want = n(JHT.lookup(jt, [jnp.asarray(probe)], jnp.asarray(pmask)))
    got = THT.lookup(tt, [t(probe)], t(pmask))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        THT.probe_unique(tt, [t(probe)], t(pmask)).numpy(),
        n(JHT.probe_unique(jt, [jnp.asarray(probe)], jnp.asarray(pmask))))


@pytest.mark.parametrize("n_probe", [400, 4])
def test_lookup_composite_key_equals_jax(n_probe, pallas_interpret,
                                         no_launches):
    """The composite 2-key case of ``test_composite_2key_join_not_truncated``
    (merge path for many probes, lexicographic search for few)."""
    rng = np.random.default_rng(3)
    k1 = rng.integers(-2**40, 2**40, size=400).astype(np.int64)
    k2 = rng.integers(-2**40, 2**40, size=400).astype(np.int64)
    half = n_probe // 2
    idx = rng.choice(400, half, replace=False)
    p1 = np.concatenate([k1[idx], rng.integers(2**41, 2**42, n_probe - half)])
    p2 = np.concatenate([k2[idx], rng.integers(2**41, 2**42, n_probe - half)])
    mask = np.ones(n_probe, bool)
    jt, tt = _tables([k1, k2], np.ones(400, bool))
    want = n(JHT.lookup(jt, [jnp.asarray(p1), jnp.asarray(p2)],
                        jnp.asarray(mask)))
    got = THT.lookup(tt, [t(p1), t(p2)], t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:half] >= 0).all() and (got[half:] == -1).all()


def test_insert_equals_jax():
    rng = np.random.default_rng(7)
    k1 = rng.integers(0, 5, size=3000).astype(np.int64)
    k2 = rng.integers(-3, 3, size=3000).astype(np.int64)
    m = rng.random(3000) < 0.7
    jo, js, jov = JHT.insert([jnp.asarray(k1), jnp.asarray(k2)],
                             jnp.asarray(m), 64)
    to, ts, tov = THT.insert([t(k1), t(k2)], t(m), 64)
    np.testing.assert_array_equal(to.numpy(), n(jo))
    np.testing.assert_array_equal(ts.numpy(), n(js))
    assert bool(tov) == bool(jov) is False


# ---------------------------------------------------------------- agg

def _agg_inputs(seed, size=5000, capacity=16):
    rng = np.random.default_rng(seed)
    v = rng.integers(-2**40, 2**40, size=size).astype(np.int64)
    g = rng.integers(-1, capacity + 3, size=size).astype(np.int32)
    m = rng.random(size) < 0.7
    return v, g, m, capacity


def test_seg_sum_and_count_equal_jax():
    v, g, m, cap = _agg_inputs(11)
    np.testing.assert_array_equal(
        TA.seg_sum(t(v), t(g), t(m), cap, torch.int64).numpy(),
        n(JA.seg_sum(jnp.asarray(v), jnp.asarray(g), jnp.asarray(m), cap,
                     jnp.int64)))
    np.testing.assert_array_equal(
        TA.seg_count(t(g), t(m), cap).numpy(),
        n(JA.seg_count(jnp.asarray(g), jnp.asarray(m), cap)))


SEG_JAX = {"add": lambda v, g, m, c: JA.seg_sum(v, g, m, c, jnp.int64),
           "count": lambda v, g, m, c: JA.seg_count(g, m, c),
           "min": JA.seg_min, "max": JA.seg_max}


def _seg_case(seed, size, capacity, slot_dtype):
    """int64 values over the whole range (sums wrap mod 2^64), slots below
    0, inside and at or past ``capacity``, a mask of 70 % of the rows."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-2**63, 2**63 - 1, size=size, dtype=np.int64)
    g = rng.integers(-3, capacity + 3, size=size).astype(slot_dtype)
    m = rng.random(size) < 0.7
    return v, g, m


@pytest.mark.parametrize("op", ["add", "count", "min", "max"])
@pytest.mark.parametrize("slot_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("size,capacity", [(5000, 16), (3000, 4000), (0, 8),
                                           (7, 1)])
def test_seg_reduce_plain_equals_jax(op, slot_dtype, size, capacity,
                                     no_launches):
    """``seg_reduce`` on CPU tensors (its plain version) equals the JAX
    package's segment sum, count, min and max, exactly; a slot no row
    reaches holds 0 or the int64 extreme, as there."""
    v, g, m = _seg_case(size + capacity, size, capacity, slot_dtype)
    want = n(SEG_JAX[op](jnp.asarray(v), jnp.asarray(g), jnp.asarray(m),
                         capacity))
    values = None if op == "count" else t(v)
    kop = "add" if op == "count" else op
    got = CK.seg_reduce(values, t(g), t(m), capacity, kop)
    assert got.dtype == torch.int64 and got.shape == (capacity,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        CK.seg_reduce_plain(values, t(g), t(m), capacity, kop).numpy(), want)


def _warp_combine_model(slots, values, op):
    """numpy model of one row of a warp step in ``csrc/seg_reduce.cu``:
    ``__match_any_sync`` peers, the shuffle tree of ``reduce_peers`` (every
    lane reads before any writes), then the leaders (lowest lane of each
    peer group) with their slot and combined value."""
    full = 0xFFFFFFFF
    apply = {"add": lambda a, b: (a + b + 2**63) % 2**64 - 2**63,
             "min": min, "max": max}[op]
    x = [int(a) for a in values]
    peers = [sum(1 << j for j in range(32) if slots[j] == slots[i])
             for i in range(32)]
    rank = [bin(peers[i] & ((1 << i) - 1)).count("1") for i in range(32)]
    rest = [peers[i] & ((0xFFFFFFFE << i) & full) for i in range(32)]
    while any(rest):
        nxt = [(r & -r).bit_length() for r in rest]  # __ffs
        got = [x[(k - 1) & 31] for k in nxt]
        x = [apply(x[i], got[i]) if nxt[i] else x[i] for i in range(32)]
        done = sum(1 << i for i in range(32) if rank[i] & 1)
        rest = [r & ~done & full for r in rest]
        rank = [r >> 1 for r in rank]
    return [(slots[i], x[i]) for i in range(32)
            if slots[i] >= 0 and peers[i] & ((1 << i) - 1) == 0]


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("pattern", ["one_slot", "distinct", "q1_like",
                                     "skipped", "random"])
def test_warp_combine_model_equals_group_reduction(op, pattern):
    """The kernel's peer reduction gives each group's whole sum (mod 2^64),
    min or max to exactly one leader, leaders hold distinct slots (so a
    warp's own copy takes plain stores), and skipped rows (-1) reach no
    slot."""
    rng = np.random.default_rng(len(pattern))
    vals = rng.integers(-2**63, 2**63 - 1, size=32, dtype=np.int64)
    slots = {"one_slot": np.zeros(32, int),
             "distinct": rng.permutation(32),
             "q1_like": rng.choice(4, 32, p=[0.25, 0.01, 0.49, 0.25]),
             "skipped": np.where(rng.random(32) < 0.5, -1,
                                 rng.integers(0, 3, 32)),
             "random": rng.integers(-1, 9, 32)}[pattern].tolist()
    leaders = _warp_combine_model(slots, vals, op)
    assert len({s for s, _ in leaders}) == len(leaders)
    want = {}
    for s, v in zip(slots, vals.tolist()):
        if s >= 0:
            want.setdefault(s, []).append(v)
    red = {"add": lambda a: (sum(a) + 2**63) % 2**64 - 2**63,
           "min": min, "max": max}[op]
    assert dict(leaders) == {s: red(a) for s, a in want.items()}


@pytest.mark.parametrize("n_rows,capacity,want", [
    # Q1's shapes, SF1 and SF10: 6 of 64 slots
    (6_002_590, 64, (1056, 256, True)),
    (59_996_324, 64, (1056, 256, True)),
    # the privatised limit: a copy of 768 slots for each of 8 warps fills
    # 48 KiB
    (59_996_324, CK.SEG_PRIVATE_SLOTS, (1056, 256, True)),
    (59_996_324, CK.SEG_PRIVATE_SLOTS + 1, (1056, 256, False)),
    # one slot; 6,144 slots (one copy a block would fit): global
    (59_996_324, 1, (1056, 256, True)),
    (59_996_324, 6_144, (1056, 256, False)),
    # fewer rows than slots: the global branch, a block per 8 warp steps
    (100, 1000, (1, 256, False)),
    (1_000_000, 2**20, (977, 256, False)),
    # the block copies outnumber the rows: global
    (6_002_590, 6_000, (1056, 256, False)),
    # a small grid privatises while its copies are fewer than the rows
    (10_000, 64, (10, 256, True)),
    (1_500, 768, (2, 256, False)),
    (0, 64, (1, 256, False)),
])
def test_seg_reduce_plan_edges(n_rows, capacity, want):
    plan = CK.seg_reduce_plan(n_rows, capacity, 132)
    assert plan == want
    blocks, threads, privatised = plan
    assert 1 <= blocks <= 132 * CK.SEG_BLOCKS_PER_SM
    assert CK.SEG_PRIVATE_SLOTS == 768
    if privatised:
        assert threads // 32 * capacity * 8 <= CK.SEG_SHARED_BYTES
        assert blocks * capacity <= n_rows


@pytest.mark.parametrize("kind", ["sum", "count", "min", "max", "first_row"])
def test_int64_reductions_route_to_seg_reduce(kind, monkeypatch):
    """Every int64 segment sum, count, min and max goes to
    ``cuda_kernels.seg_reduce`` (its plain version here on the CPU), and so
    does the direct group ids' first row; float sums and int32 extremes do
    not."""
    calls = []
    real = CK.seg_reduce
    monkeypatch.setattr(CK, "seg_reduce",
                        lambda *a: calls.append(a[4:]) or real(*a))
    v, g, m, cap = _agg_inputs(13)
    tv, tg, tm = t(v), t(g), t(m)
    if kind == "sum":
        TA.seg_sum(tv, tg, tm, cap, torch.int64)
        TA.seg_sum(tv.to(torch.int32), tg, tm, cap, torch.int64)
        assert calls == [(), ()]
        TA.seg_sum(tv.to(torch.float64), tg, tm, cap)
    elif kind == "count":
        TA.seg_count(tg, tm, cap)
        TA.seg_any(tm, tg, tm, cap)
        assert calls == [(), ()]
    elif kind in ("min", "max"):
        f = TA.seg_min if kind == "min" else TA.seg_max
        f(tv, tg, tm, cap)
        assert calls == [(kind,)]
        f(tv.to(torch.int32), tg, tm, cap)
        f(tv.to(torch.float64), tg, tm, cap)
    else:
        from presto_tpu_torch.exec.runner import LocalRunner
        r = LocalRunner(scale_factor=0.001, device="cpu")
        got = r.run_sql("select l_returnflag, l_linestatus, count(*) c "
                        "from lineitem group by 1, 2 order by 1, 2")
        assert got.row_count == 4
        assert ("min",) in calls and () in calls
        return
    assert len(calls) == (1 if kind in ("min", "max") else 2)


def test_g_sum_equals_jax(no_launches):
    v, _, m, _ = _agg_inputs(12)
    want = int(JA.g_sum(jnp.asarray(v), jnp.asarray(m), jnp.int64))
    assert int(TA.g_sum(t(v), t(m), torch.int64)) == want
    d = v.astype(np.int32)  # a narrower integer input widens first
    assert int(TA.g_sum(t(d), t(m), torch.int64)) == \
        int(JA.g_sum(jnp.asarray(d), jnp.asarray(m), jnp.int64))


def test_sum128_equal_jax():
    v, g, m, cap = _agg_inputs(13)
    v = v * 2**22  # addends near 2^62: the sums need the hi word
    jh, jl = JI.seg_sum128_from_i64(jnp.asarray(v), jnp.asarray(g),
                                    jnp.asarray(m), cap)
    th, tl = TI.seg_sum128_from_i64(t(v), t(g), t(m), cap)
    np.testing.assert_array_equal(th.numpy(), n(jh))
    np.testing.assert_array_equal(tl.numpy(), n(jl))
    jh, jl = JI.g_sum128_from_i64(jnp.asarray(v), jnp.asarray(m))
    th, tl = TI.g_sum128_from_i64(t(v), t(m))
    assert (int(th), int(tl)) == (int(jh), int(jl))
    w = np.stack([v >> 3, v], axis=-1)  # int128 addends
    jh, jl = JI.seg_sum128_from_i128(jnp.asarray(w), jnp.asarray(g),
                                     jnp.asarray(m), cap)
    th, tl = TI.seg_sum128_from_i128(t(w), t(g), t(m), cap)
    np.testing.assert_array_equal(th.numpy(), n(jh))
    np.testing.assert_array_equal(tl.numpy(), n(jl))
    jh, jl = JI.g_sum128_from_i128(jnp.asarray(w), jnp.asarray(m))
    th, tl = TI.g_sum128_from_i128(t(w), t(m))
    assert (int(th), int(tl)) == (int(jh), int(jl))


# ---------------------------------------------------------------- int128

def _i128_operands(seed, size=64):
    rng = np.random.default_rng(seed)
    a = rng.integers(-2**62, 2**62, size=(size, 2)).astype(np.int64)
    b = rng.integers(-2**62, 2**62, size=(size, 2)).astype(np.int64)
    b[:, 0] >>= 40  # divisors of mixed width, both signs
    b[:8] = [[0, 7], [-1, -7], [0, 1], [-1, -1], [0, 10**18],
             [0, 2**62], [-1, -(10**9)], [5, 0]]
    return a, b


@pytest.mark.parametrize("op", ["mul", "div_round_half_up", "add", "sub"])
def test_int128_ops_equal_jax(op):
    a, b = _i128_operands(21)
    args_j = [jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
              jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1])]
    args_t = [t(a[:, 0]), t(a[:, 1]), t(b[:, 0]), t(b[:, 1])]
    jh, jl = getattr(JI, op)(*args_j)
    th, tl = getattr(TI, op)(*args_t)
    np.testing.assert_array_equal(th.numpy(), n(jh))
    np.testing.assert_array_equal(tl.numpy(), n(jl))


@pytest.mark.parametrize("frm,to", [(2, 6), (6, 2), (0, 30), (30, 4)])
def test_int128_rescale_equals_jax(frm, to):
    a, _ = _i128_operands(22)
    a[:, 0] >>= 20  # keep scale-ups inside DECIMAL(38)
    jh, jl = JI.rescale(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), frm, to)
    th, tl = TI.rescale(t(a[:, 0]), t(a[:, 1]), frm, to)
    np.testing.assert_array_equal(th.numpy(), n(jh))
    np.testing.assert_array_equal(tl.numpy(), n(jl))


def test_decimal_rounding_equals_jax():
    from presto_tpu.ops import decimal as JD
    rng = np.random.default_rng(23)
    x = rng.integers(-10**15, 10**15, size=2000).astype(np.int64)
    y = rng.integers(-999, 999, size=2000).astype(np.int64)
    np.testing.assert_array_equal(
        TD.div_round_half_up(t(x), t(y)).numpy(),
        n(JD.div_round_half_up(jnp.asarray(x), jnp.asarray(y))))
    for fs, ts in ((2, 0), (0, 4), (4, 1)):
        np.testing.assert_array_equal(
            TD.rescale(t(x), fs, ts).numpy(),
            n(JD.rescale(jnp.asarray(x), fs, ts)))
    np.testing.assert_array_equal(
        TD.decimal_div(t(x), 2, t(y), 2, 6).numpy(),
        n(JD.decimal_div(jnp.asarray(x), 2, jnp.asarray(y), 2, 6)))


# ---------------------------------------------------------------- sort

def test_argsort_multi_equals_jax():
    rng = np.random.default_rng(31)
    a = rng.integers(0, 4, size=3000).astype(np.int32)
    b = rng.integers(-2**40, 2**40, size=3000).astype(np.int64)
    m = rng.random(3000) < 0.8
    want = n(JS.argsort_multi([(jnp.asarray(a), False),
                               (jnp.asarray(b), True)], jnp.asarray(m)))
    got = TS.argsort_multi([(t(a), False), (t(b), True)], t(m))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- columns

def test_dcol_from_jax_dcol():
    """A JAX DCol (through numpy) becomes the port's DCol with equal
    arrays and the port's own type objects."""
    from presto_tpu.exec.columns import from_host as jfrom_host
    from presto_tpu.tpch import generator as JG
    from presto_tpu_torch.data import types as TT
    from presto_tpu_torch.exec.columns import dcol_from_arrays
    part = JG.generate("part", 0.01)
    for name in ("p_partkey", "p_type", "p_retailprice"):
        jc = jfrom_host(part.columns[name])
        tc = dcol_from_arrays(jc, "cpu")
        assert tc.kind == jc.kind and type(tc.dtype).__module__ == \
            TT.__name__ and str(tc.dtype) == str(jc.dtype)
        np.testing.assert_array_equal(tc.values.numpy(), n(jc.values))


@pytest.mark.parametrize("with_dict", [False, True])
def test_from_host_rle_equals_jax(with_dict):
    """A run-length host column expands on upload exactly as JAX's does."""
    from presto_tpu.data import column as JC
    from presto_tpu.data import types as JT
    from presto_tpu.exec.columns import from_host as jfrom_host
    from presto_tpu_torch.data import column as TC
    from presto_tpu_torch.data import types as TT
    from presto_tpu_torch.exec.columns import from_host
    rng = np.random.default_rng(41)
    runs = rng.integers(0, 7, size=50)
    lens = rng.integers(0, 9, size=50)
    valid = rng.random(50) < 0.8
    kw = dict(validity=valid, dictionary=[f"s{i}" for i in range(7)]) \
        if with_dict else {}
    jt, tt = (JT.varchar(4), TT.varchar(4)) if with_dict \
        else (JT.BIGINT, TT.BIGINT)
    want = jfrom_host(JC.rle_column(jt, runs, lens, **kw))
    got = from_host(TC.rle_column(tt, runs, lens, **kw), "cpu")
    assert got.kind == want.kind
    np.testing.assert_array_equal(got.values.numpy(), n(want.values))
    if with_dict:
        np.testing.assert_array_equal(got.validity.numpy(),
                                      n(want.validity))
        assert list(got.dictionary.strings) == list(want.dictionary.strings)
