"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), its correctness limits (limits/<cell>.json) and
each per-layer metric's reader (metrics/<metric>.py). Adding a cell, a
configuration, a mix or a metric adds files and entries; no file here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict  # configs/<config>.json
    traffic: Dict  # traffic/<traffic>.json
    limits: Dict[str, float]  # limits/<cell>.json
    end_to_end: List[Dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Optional[str] = None, here: str = HERE) -> Cell:
    bench = _load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = configs[w["config"]]["file"]
    cfg_path = cfg_file if os.path.isabs(cfg_file) else os.path.join(os.path.dirname(here), cfg_file)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_load_json(cfg_path),
        traffic=_load_json(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        limits=_load_json(os.path.join(here, "limits", f"{name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def reader(metric: str, here: str = HERE) -> Callable:
    """The read(ctx) function of metrics/<metric>.py (a name may hold dots,
    so the file is loaded by path)."""
    path = os.path.join(here, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("outage_bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
