"""``roofline/sorted_probe.py`` reproduces the bound column of the kernel
table in PERF.md (bytes over 3.35 TB/s)."""

import json
import os

import pytest

from conftest import BENCH
from harness.spec import load_module

PEAK = json.load(open(os.path.join(BENCH, "peaks.json")))["H100"]
MODEL = load_module(os.path.join(BENCH, "roofline", "sorted_probe.py"),
                    "sorted_probe_roofline_model")


@pytest.mark.parametrize("cap, n, p, bound_ms", [
    (200_000, 200_000, 75_143, 0.000747),          # Q14
    (1_500_000, 1_500_000, 6_002_590, 0.025084),   # lineitem -> orders
    (145_901, 145_901, 6_002_590, 0.021850),       # Q3's largest
    (8, 5, 11_745_000, 0.042072),                  # TPC-DS q72: 5 valid keys
])
def test_sorted_probe_bytes_reproduce_the_bound(cap, n, p, bound_ms):
    ms = MODEL.bytes_moved(cap=cap, p=p, n_valid=n) \
        / PEAK["hbm_bytes_per_s"] * 1e3
    assert round(ms, 6) == bound_ms


def test_sorted_probe_is_bound_by_bytes():
    for n, p in ((200_000, 75_143), (1_500_000, 6_002_590)):
        kw = dict(cap=n, p=p, n_valid=n)
        assert MODEL.operations(**kw) / PEAK["int_ops_per_s"] < \
            MODEL.bytes_moved(**kw) / PEAK["hbm_bytes_per_s"]


def test_only_the_valid_keys_count():
    assert MODEL.bytes_moved(cap=1000, p=10, n_valid=100) == \
        100 * 8 + 10 * 12
