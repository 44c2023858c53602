"""Everything the harness runs is found by name, from ``BENCHMARK.json``:

- a cell's ``config`` is ``configs/<config>.json``, which names the
  modules of its data: ``generator`` and ``reference`` (imported as
  ``reference.<name>``: ``generate(sf, device)``; ``Tables(host, device,
  low_precision)`` and ``answer(tables, statement, params)``) and
  ``connector`` (``connectors/<name>.py``: ``attach(runner, host)``);
- its ``traffic`` is ``traffic/<traffic>.json``, which names its statement
  set, ``reference/<statements>.json``, and its ``driver``,
  ``drivers/<name>.py`` (``open(sf, device, attach, clients)``);
- each metric is read by ``metrics/<name>.py`` (``read(ctx)``);
- a kernel's bytes and operations per launch are ``roofline/<kernel>.py``.

So a later change adds a configuration, a traffic mix, a metric or a
kernel's roofline by adding files and entries, never by editing one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str) -> ModuleType:
    """The module at ``path``, loaded once per process as ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    statements: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str

    def _file(self, kind: str, name: str) -> ModuleType:
        return load_module(os.path.join(self.bench_dir, kind, f"{name}.py"),
                           f"perfbench_{kind}_{name}")

    def _reference(self, key: str) -> ModuleType:
        if self.bench_dir not in sys.path:
            sys.path.insert(0, self.bench_dir)
        return importlib.import_module(f"reference.{self.config[key]}")

    def generator(self) -> ModuleType:
        return self._reference("generator")

    def reference(self) -> ModuleType:
        return self._reference("reference")

    def connector(self) -> ModuleType:
        return self._file("connectors", self.config["connector"])

    def driver(self) -> ModuleType:
        return self._file("drivers", self.traffic["driver"])

    def reader(self, metric: str) -> ModuleType:
        return self._file("metrics", metric)

    def roofline(self, kernel: str) -> ModuleType:
        return self._file("roofline", kernel)


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    bench_dir = os.path.join(root, bench["paths"][0])
    config = read_json(os.path.join(bench_dir, "configs",
                                    f"{w['config']}.json"))
    traffic = read_json(os.path.join(bench_dir, "traffic",
                                     f"{w['traffic']}.json"))
    statements = read_json(os.path.join(bench_dir, "reference",
                                        f"{traffic['statements']}.json"))
    return Cell(workload, int(w["chips"]), config, traffic, statements,
                bench["end_to_end"], bench["per_layer"], bench_dir)


def peaks(bench_dir: str) -> Dict[str, dict]:
    return read_json(os.path.join(bench_dir, "peaks.json"))
