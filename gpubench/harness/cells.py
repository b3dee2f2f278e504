"""A cell of ``BENCHMARK.json`` and the files it is found by.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, which :func:`resolve` finds
by the names ``BENCHMARK.json`` gives, so that a new cell, configuration
or metric is new files and new entries, and no edit:

- a configuration: the file its entry names (``configs/<config>.json``)
  and its plain reference, ``reference/<config>.py``;
- a traffic mix: ``traffic/<traffic>.json``, whose ``"driver"`` names
  the general generator that reads it, ``drivers/<driver>.py``;
- the limits of the comparison that decides ``correct`` in a cell:
  ``limits/<cell>.json``;
- a per-layer metric: its reader, ``metrics/<metric>.py``, a module with
  ``read(readings) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict           # the configuration file, as run
    traffic_name: str
    traffic: dict          # the traffic mix's parameters
    limits: Dict[str, float]
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports
    driver: object          # drivers/<driver>.py
    reference: object       # reference/<config>.py
    readers: Dict[str, object]  # per-layer metric name -> its reader


def load_module(path: str):
    """The module in the file at `path`, loaded by its path (the files
    are named after the names in BENCHMARK.json, which may hold '.' and
    '-'), and kept in ``sys.modules`` under a name made from that path."""
    key = "gpubench_" + re.sub(r"[^A-Za-z0-9_]", "_", os.path.relpath(
        os.path.abspath(path), ROOT))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in `cell`: listed there by its
    ``workloads`` key, or, without one, in every cell (``setup_s``)."""
    return cell in metric.get("workloads", [cell])


def resolve(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of ``<root>/BENCHMARK.json`` with its files; the
    benchmark's own files are those under ``<root>/gpubench``. Raises
    KeyError for a cell it does not list and FileNotFoundError for a
    file that is missing."""
    bench = load_benchmark(root)
    here = os.path.join(root, "gpubench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it lists "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = _read_json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if applies(m, name)]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=_read_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=traffic,
        limits=_read_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=e2e,
        per_layer=per_layer,
        driver=load_module(os.path.join(here, "drivers",
                                        traffic["driver"] + ".py")),
        reference=load_module(os.path.join(here, "reference",
                                           w["config"] + ".py")),
        readers={m["name"]: load_module(os.path.join(
            here, "metrics", m["name"] + ".py")) for m in per_layer},
    )
