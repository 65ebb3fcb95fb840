"""Find a cell's configuration, traffic mix, loop and metric readers by
the names in ``BENCHMARK.json``, each in a file of its own:

* ``benchmark/configs/<config>.json``
* ``benchmark/traffic/<traffic>.json``, which names its loop kind,
  ``benchmark/loops/<loop>.py``
* ``benchmark/metrics/<metric>.py`` for each per-layer metric, or, where
  there is no such file, ``benchmark/metrics/<base>.py`` for the part of
  its name before the first dot: ``device_idle_pct.chain`` and
  ``device_idle_pct.pagerank`` are one quantity, split by the end-to-end
  metric it moves, and share ``device_idle_pct.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

__all__ = ["Cell", "load_cell", "load_reader", "reader_path", "BENCH_DIR",
           "ROOT"]


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list   # the metric entries of BENCHMARK.json this cell reports
    per_layer: list

    def loop_module(self):
        return importlib.import_module(f"benchmark.loops.{self.traffic['loop']}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``spec``)."""
    if spec is None:
        spec = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    config = _json(os.path.join(BENCH_DIR, "configs", f"{w['config']}.json"))
    traffic = _json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def reader_path(metric: str) -> str:
    """The file that reads ``metric``: its own, or its base name's."""
    own = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    if os.path.isfile(own):
        return own
    return os.path.join(BENCH_DIR, "metrics", f"{metric.split('.')[0]}.py")


def load_reader(metric: str):
    """``read(run) -> number or None`` of the metric's reader (a metric's
    name may hold dots, so the file is loaded by its path)."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
