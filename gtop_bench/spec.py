"""Find a cell's files by name.

``BENCHMARK.json`` at the checkout's root names every cell, configuration
and metric; each has a file of its own under ``gtop_bench/``:

* ``configs/<config>.json``: the deployment (map, optimizer, sources);
* ``traffic/<traffic>.json``: the mix, whose ``driver`` key names the
  module under ``gtop_bench/drivers/`` that drives it (a new mix of an
  existing kind is data alone);
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``.

A new cell or metric is new files and new entries, with no edit here.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    root: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the metric entries the cell reports untraced
    per_layer: list       # and traced


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, "gtop_bench")
    return Cell(
        name=name, root=root, entry=entry,
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(here, "traffic", entry["traffic"] + ".json")),
        limits=_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def _load(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = os.path.join(root, "gtop_bench", "metrics", metric + ".py")
    return _load(path, "gtop_metric_" + re.sub(r"\W", "_", metric)).read


def driver(name: str):
    """The driver module ``drivers/<name>.py``: a ``Driver`` class."""
    return importlib.import_module("gtop_bench.drivers." + name)
