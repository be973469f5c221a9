"""What a run reads from ``BENCHMARK.json`` and the benchmark's data
files, each found by its name:

- ``benchmark/configs/<config>.json``: the configuration (``file`` in
  ``BENCHMARK.json``): its published sizes, its params, its generator;
- ``benchmark/traffic/<traffic>.json``: the traffic mix, naming the
  driver (``benchmark/gbdtbench/drivers/<driver>.py``) and its knobs;
- ``benchmark/limits/<cell>.json``: the limit of each number that the
  cell's check compares;
- ``benchmark/metrics/<metric>.py``: one reader a metric, end-to-end or
  per-layer, with ``read(run) -> float | None``.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files of one cell."""

    def __init__(self, workload: str, root: str = ROOT):
        self.root = root
        self.bench = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        confs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = confs[self.cell["config"]]
        self.config = _json(os.path.join(root, self.config_entry["file"]))
        bench_dir = os.path.join(root, "benchmark")
        self.traffic = _json(os.path.join(bench_dir, "traffic",
                                          self.cell["traffic"] + ".json"))
        self.limits = _json(os.path.join(bench_dir, "limits",
                                         workload + ".json"))
        self.metrics_dir = os.path.join(bench_dir, "metrics")

    @property
    def name(self) -> str:
        return self.cell["name"]

    def metrics(self, kind: str) -> List[dict]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, name: str):
        path = os.path.join(self.metrics_dir, name + ".py")
        spec = importlib.util.spec_from_file_location(
            "gbdtbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def params(self) -> Dict:
        """The configuration's params under the traffic's."""
        p = dict(self.config.get("params", {}))
        p.update(self.traffic.get("params", {}))
        return p
