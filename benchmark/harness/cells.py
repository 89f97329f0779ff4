"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names each cell (``workloads``),
its configuration and its traffic mix as data; every piece lives in a
file of its own under this folder, found by name:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the mix's parameters, read by ``traffic.py``;
- ``cells/<workload>.json``: the cell's correctness sample and limits;
- ``metrics/<metric>.py``: one reader a metric, ``read(ctx) -> float | None``.

A later cell, configuration, mix or metric is new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT, folder: Path = HERE, spec: dict | None = None):
        self.root = Path(root)
        self.folder = Path(folder)
        self.spec = spec if spec is not None else json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        known = ", ".join(w["name"] for w in self.spec["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.folder / "traffic" / f"{name}.json").read_text())

    def cell(self, workload: str) -> dict:
        return json.loads((self.folder / "cells" / f"{workload}.json").read_text())

    def metrics_for(self, workload: str, trace: bool) -> list:
        """The metric entries a cell reports: its ``end_to_end`` ones in a
        plain run, its ``per_layer`` ones in a traced run (an entry without
        ``workloads`` applies to every cell)."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.folder / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read
