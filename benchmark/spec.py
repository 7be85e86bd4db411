"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` of its ``configs`` entry (JSON);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, which names its
  command;
- a command of the port's CLI: ``benchmark/commands/<command>.py`` with
  ``argv`` and ``judge``;
- a metric: ``benchmark/metrics/<name>.py`` with
  ``read(run) -> float | None``; where no file has the whole name, the
  name without its last ``.<suffix>`` (``device_idle_pct.scan`` reads
  ``device_idle_pct.py``), and a ``<kernel>_roofline`` with no file of its
  own reads the kernel's share of its roofline;
- a kernel's count of operations and bytes:
  ``benchmark/rooflines/<kernel>.py`` with ``KERNELS`` (device kernel
  names) and ``work(run) -> (ops by type, bytes)``.

A new cell, mix or metric is new files and new entries; nothing here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType, SimpleNamespace
from typing import List, Optional

__all__ = ["Spec", "Cell", "load_spec", "load_module"]


def load_module(path: str, name: str) -> ModuleType:
    """The Python file ``path`` as a module (not entered in
    ``sys.modules``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file, with "name"
    traffic: dict          # the traffic file, with "name"
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclasses.dataclass
class Spec:
    root: str
    doc: dict

    def _path(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.doc["workloads"]}
        if name not in cells:
            raise SystemExit(f"error: no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in self.doc["configs"]}[w["config"]]
        with open(self._path(conf["file"])) as fh:
            config = dict(json.load(fh), name=conf["name"])
        with open(self._path("benchmark", "traffic",
                             f"{w['traffic']}.json")) as fh:
            traffic = dict(json.load(fh), name=w["traffic"])

        def mine(metrics):
            return [m for m in metrics
                    if name in m.get("workloads", [name])]

        return Cell(name, int(w["chips"]), config, traffic,
                    mine(self.doc["end_to_end"]), mine(self.doc["per_layer"]))

    def metric_reader(self, name: str):
        """An object with ``read(run)`` for metric ``name``."""
        for stem in dict.fromkeys((name, name.rsplit(".", 1)[0])):
            path = self._path("benchmark", "metrics", f"{stem}.py")
            if os.path.exists(path):
                return load_module(
                    path, f"benchmark_metric_{stem.replace('.', '_')}")
        kernel = name[:-len("_roofline")]
        if name.endswith("_roofline") and os.path.exists(
                self._path("benchmark", "rooflines", f"{kernel}.py")):
            from benchmark.peaks import roofline_share

            return SimpleNamespace(read=lambda run: roofline_share(run,
                                                                   kernel))
        raise FileNotFoundError(f"no reader for metric {name!r}")

    def command(self, name: str) -> ModuleType:
        return load_module(self._path("benchmark", "commands", f"{name}.py"),
                           f"benchmark_command_{name.replace('-', '_')}")

    def roofline(self, kernel: str) -> ModuleType:
        return load_module(self._path("benchmark", "rooflines",
                                      f"{kernel}.py"),
                           f"benchmark_roofline_{kernel}")


def load_spec(root: Optional[str] = None) -> Spec:
    root = os.path.abspath(root or os.getcwd())
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return Spec(root, json.load(fh))
