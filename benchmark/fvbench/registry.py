"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; every part lives in a file of its own,
found by that name:

* ``configs/<config>.json`` (the path in the configuration's ``file``);
* ``traffic/<traffic>.json`` (or ``.py``, a module whose ``TRAFFIC`` is
  the mix's dict): the mix, read by the driver it names;
* ``drivers/<driver>.py``: the traffic's ``driver``, with
  ``run(cell, seed, seconds, tracing, device, started, rank=0, world=1,
  port=0)`` (see ``cells``);
* ``limits/<workload>.json``: the limit of each number compared;
* ``metrics/<metric>.py``: a reader with ``read(ctx)`` per per-layer metric;
* ``stages/<stage>.json``: the port's kernel symbols and the stages of
  the metric's work they do.

Adding a cell or a metric adds files and entries; nothing here changes.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os
from typing import Dict, List, NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]       # the end-to-end metrics this cell reports
    per_layer: List[Dict]        # the per-layer metrics this cell reports


def load_benchmark() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bench = load_benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        config = json.load(f)
    traffic = _traffic(w["traffic"])
    with open(os.path.join(BENCH_DIR, "limits", name + ".json")) as f:
        limits = {k: float(v["limit"]) for k, v in json.load(f)["compared"].items()}
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def _module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, loaded."""
    path = os.path.join(BENCH_DIR, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"fvbench_{folder}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _traffic(name: str) -> Dict:
    """The mix ``traffic/<name>.json``, or the ``TRAFFIC`` of
    ``traffic/<name>.py``."""
    path = os.path.join(BENCH_DIR, "traffic", name + ".json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return dict(_module("traffic", name).TRAFFIC)


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def driver(name: str):
    """The ``run`` of ``drivers/<name>.py``."""
    return _module("drivers", name).run


def stages() -> Dict[str, Dict]:
    """Every stage file: name -> {"symbols": [...], "work": [...]}."""
    out = {}
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "stages", "*.json"))):
        with open(path) as f:
            out[os.path.splitext(os.path.basename(path))[0]] = json.load(f)
    return out
