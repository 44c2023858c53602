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
    assert CK.LAUNCHES == {"masked_sum": 0, "sorted_probe": 0}


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
