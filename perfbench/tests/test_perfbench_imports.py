"""Nothing the harness, the reference or the readers load is JAX or the
JAX package, compared by whole top-level names (``presto_tpu_torch`` is
the program, not ``presto_tpu``); the reference imports nothing of the
program, ``tools`` or ``chip_smoke``."""

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "presto_tpu"}
NOT_IN_REFERENCE = FORBIDDEN | {"presto_tpu_torch", "tools", "chip_smoke"}


def _sources():
    for d, _, files in os.walk(BENCH):
        if os.sep + "tests" in d[len(BENCH):] or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    """Top-level names of every module ``path`` imports (absolute)."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def test_whole_names_are_compared():
    assert "presto_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "presto_tpu.exec".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imported(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            bad = set(_imported(os.path.join(ref, f))) & NOT_IN_REFERENCE
            assert not bad, (f, bad)


def test_a_run_loads_no_jax_module():
    """A whole run (on the CPU, at SF0.01, a short window) in a fresh
    process, then the run's own check of ``sys.modules``."""
    code = f"""
import json, sys
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
from harness import bench, spec
from reference import tpch_gen
cell = spec.load_cell("tpch-sf1.power")
cell.config = dict(cell.config, scale_factor=0.01,
                   tables=tpch_gen.row_counts(0.01))
res = bench.run(cell, 5, 0.5, False, "cpu", bench.process_start_s())
print(json.dumps({{"correct": res["correct"],
                  "forbidden": bench.forbidden_modules(),
                  "loaded": sorted({{m.split('.')[0] for m in sys.modules}})}}))
"""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["forbidden"] == []
    assert "presto_tpu_torch" in res["loaded"]
    assert not FORBIDDEN & set(res["loaded"])


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "tpch-sf1.power", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
