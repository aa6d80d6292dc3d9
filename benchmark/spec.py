"""What a cell is made of, found by name: the cell's entry in
``BENCHMARK.json``, its configuration (``configs/<config>.json``), its
traffic mix (``traffic/<traffic>.json``) and the reader of each of its
metrics (``metrics/<metric>.py``).  A later cell, mix or metric is a new
file and a new entry; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    """One workload of the benchmark, resolved."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)  # metric entries
    per_layer: list = field(default_factory=list)

    def metrics(self, traced: bool) -> list:
        """The metric entries a run reports: per-layer with a trace, else
        end-to-end."""
        return self.per_layer if traced else self.end_to_end


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """Resolve the workload ``name`` of ``root``/BENCHMARK.json; raises
    KeyError for an unknown name and OSError for a missing file."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; choose from "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = _load_json(os.path.join(root, conf["file"]))
    traffic = _load_json(os.path.join(HERE, "traffic",
                                      f"{work['traffic']}.json"))
    return Cell(
        name=name, chips=int(work["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``: it returns
    the metric's value from a finished run, or None where the run holds
    nothing to read."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
