"""The harness finds configurations, traffic mixes, metric readers and
kernel rooflines by name: a copy of the benchmark with one of each added
runs them with no file edited. ``BENCHMARK.json`` keeps to the contract's
names, units and shapes."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CONTRACT = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_names_and_units_use_only_the_allowed_characters():
    b = CONTRACT
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [w["config"] for w in b["workloads"]] + \
        [w["traffic"] for w in b["workloads"]] + \
        [k for c in b["configs"] for k in c["reduced"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [c["why"] for c in b["configs"]] + \
            [w["why"] for w in b["workloads"]] + \
            [m["layer"] for m in b["per_layer"]] + \
            [c["source"] for c in b["configs"]] + b["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and \
            "\t" not in text, text


def test_benchmark_keeps_the_contract_shape():
    b = CONTRACT
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for c in b["configs"]:
        assert c["file"].startswith("perfbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert set(c["reduced"]) == set(conf["reduced"])
        for d, key in (("reference", "generator"), ("reference", "reference"),
                       ("connectors", "connector")):
            assert os.path.exists(os.path.join(BENCH, d, f"{conf[key]}.py"))
    seen = set()
    for w in b["workloads"]:
        assert w["chips"] in (1, 4)
        traffic = json.load(open(os.path.join(BENCH, "traffic",
                                              f"{w['traffic']}.json")))
        assert os.path.exists(os.path.join(BENCH, "drivers",
                                           f"{traffic['driver']}.py"))
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    CONTRACT["end_to_end"] +
                                    CONTRACT["per_layer"]])
def test_every_metric_has_its_reader(metric):
    m = next(x for x in CONTRACT["end_to_end"] + CONTRACT["per_layer"]
             if x["name"] == metric)
    reader = spec.load_cell(CONTRACT["workloads"][0]["name"]).reader(metric)
    assert reader.UNIT == m["unit"]
    assert reader.LAYER == m.get("layer")
    assert reader.MOVES == m.get("moves")


RUN_IN_COPY = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
from harness import bench, spec
cell = spec.load_cell("tpch-tiny.pair", root={root!r})
res = bench.run(cell, 3, 0.3, True, "cpu", bench.process_start_s())
res["files"] = [m.__file__ for m in (cell.generator(), cell.reference(),
                                     cell.connector(), cell.driver())]
print(json.dumps(res))
"""


def test_added_files_are_found_with_no_edit(tmp_path):
    """A configuration naming its own generator and connector, a traffic
    of two clients through its own driver, and a metric reader, added as
    files to a copy of the benchmark, run with no file edited."""
    from reference import tpch_gen
    root = tmp_path / "checkout"
    bench_dir = root / "perfbench"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "presto_tpu_torch"),
               root / "presto_tpu_torch")
    b = json.loads(json.dumps(CONTRACT))
    conf = json.load(open(os.path.join(BENCH, "configs", "tpch-sf1.json")))
    conf.update(name="tpch-tiny", scale_factor=0.01,
                tables=tpch_gen.row_counts(0.01), generator="tiny_gen",
                connector="tiny")
    (bench_dir / "configs" / "tpch-tiny.json").write_text(json.dumps(conf))
    (bench_dir / "reference" / "tiny_gen.py").write_text(
        "from . import tpch_gen\n\n"
        "def generate(sf, device='cpu'):\n"
        "    return tpch_gen.generate(sf, device)\n")
    shutil.copy(bench_dir / "connectors" / "tpch.py",
                bench_dir / "connectors" / "tiny.py")
    shutil.copy(bench_dir / "drivers" / "dbapi.py",
                bench_dir / "drivers" / "dbapi_pair.py")
    traffic = json.load(open(os.path.join(BENCH, "traffic", "power.json")))
    traffic.update(stream=[6, 14], parameter_pool=[5], clients=2,
                   driver="dbapi_pair")
    (bench_dir / "traffic" / "pair.json").write_text(json.dumps(traffic))
    (bench_dir / "metrics" / "clients_seen.py").write_text(
        'UNIT, LAYER, MOVES = "clients", "client edge", "qps"\n'
        'def read(ctx):\n'
        '    return float(len({s["client"] for s in ctx["statements"]}))\n')
    b["configs"].append(dict(b["configs"][0], name="tpch-tiny",
                             file="perfbench/configs/tpch-tiny.json"))
    b["workloads"].append({"name": "tpch-tiny.pair", "config": "tpch-tiny",
                           "traffic": "pair", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "clients_seen", "unit": "clients",
                           "better": "higher", "source": "host_clock",
                           "layer": "client edge", "moves": "qps"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    code = RUN_IN_COPY.format(bench=str(bench_dir), root=str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(root),
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"]["clients_seen"]["value"] == 2
    assert "host_syncs" in res["metrics"]
    assert [os.path.relpath(f, bench_dir) for f in res["files"]] == [
        "reference/tiny_gen.py", "reference/oracle.py",
        "connectors/tiny.py", "drivers/dbapi_pair.py"]
