"""BENCHMARK.json and the files it names, found by name: a cell's
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), its correctness limits (limits/<cell>.json),
each per-layer metric's reader (metrics/<metric>.py) and the plain
reference's st-GNN family (reference/st_gnn/<st_gnn>.py, found by
reference/model.py). Adding a cell, a configuration, a mix, a metric or
an st-GNN family adds files and entries; no file here changes.

A mix may hold a "model" group: training knobs that the program keeps in
its model configuration (a scheduled-sampling rate), merged over the
configuration's "model" group for the program and the reference alike.
It may set only the keys that the configuration's st-GNN family names as
its training knobs (MIX_KEYS, dotted paths), never a width or any other
key of the architecture.
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
    config: Dict  # configs/<config>.json, its model group under the mix's
    traffic: Dict  # traffic/<traffic>.json
    limits: Dict[str, float]  # limits/<cell>.json
    end_to_end: List[Dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[Dict]


def _dotted(tree: Dict, where: str = "") -> List[tuple]:
    out: List[tuple] = []
    for k, v in tree.items():
        out += _dotted(v, f"{where}{k}.") if isinstance(v, dict) else [(f"{where}{k}", v)]
    return out


def _mix_model(model: Dict, mix: Dict) -> None:
    """The mix's "model" group set over the configuration's, key by key:
    each a training knob of the configuration's st-GNN family, and a key
    the configuration has."""
    if not mix:
        return
    from outage_bench.reference import model as ref

    knobs = ref.family(model).MIX_KEYS
    for path, v in _dotted(mix):
        if path not in knobs:
            raise KeyError(f"the mix sets model.{path}; st_gnn {model['st_gnn']!r} lets a mix "
                           f"set only {sorted(knobs)}")
        *head, last = path.split(".")
        d = model
        for k in head:
            d = d.get(k, {})
        if last not in d:
            raise KeyError(f"the mix sets model.{path}, which the configuration does not have")
        d[last] = v


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
    config = _load_json(cfg_path)
    traffic = _load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    _mix_model(config["model"], traffic.get("model", {}))
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
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
