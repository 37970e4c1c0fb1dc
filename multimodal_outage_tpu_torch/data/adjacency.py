"""County-contiguity adjacency and static diffusion supports (numpy only).

The port's own copy of the JAX package's data/adjacency.py (reference
utils.py:152-180). "identity" reproduces the reference's
"doubletransition" quirk (a single identity matrix); "doubletransition"
is the true dual random walk [D⁻¹A, D⁻¹Aᵀ].
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple

import numpy as np

# packaged with the wheel (pyproject [tool.setuptools.package-data])
_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "graph",
    "adj_mx_fl.csv",
)


def default_adjacency_path() -> str:
    return os.path.normpath(_ASSET)


def load_adjacency_csv(path: str | None = None) -> Tuple[List[str], np.ndarray]:
    """Header+rows adjacency CSV → (county_names, dense [N, N] float32)."""
    path = path or default_adjacency_path()
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        names = [h.strip() for h in header[1:]]
        rows = [[float(v) for v in row[1:]] for row in reader]
    adj = np.asarray(rows, dtype=np.float32)
    if adj.shape != (len(names), len(names)):
        raise ValueError(f"Adjacency shape {adj.shape} != ({len(names)},)*2")
    return names, adj


def asym_adj(adj: np.ndarray) -> np.ndarray:
    """Row-normalized transition matrix D⁻¹A (reference utils.py:152-158)."""
    adj = np.asarray(adj, dtype=np.float64)
    rowsum = adj.sum(axis=1)
    d_inv = np.where(rowsum > 0, 1.0 / np.where(rowsum > 0, rowsum, 1.0), 0.0)
    return (d_inv[:, None] * adj).astype(np.float32)


def build_supports(adj: np.ndarray, adjtype: str = "identity") -> List[np.ndarray]:
    n = adj.shape[0]
    if adjtype == "identity":
        return [np.eye(n, dtype=np.float32)]
    if adjtype == "transition":
        return [asym_adj(adj)]
    if adjtype == "doubletransition":
        return [asym_adj(adj), asym_adj(adj.T)]
    raise ValueError(f"adj type {adjtype!r} not defined")


# DCRNN's filter_type → adjtype (the JAX package's train/loop.py:108-114;
# reference models/unet.py:17)
DCRNN_ADJTYPES = {
    "dual_random_walk": "doubletransition",
    "random_walk": "transition",
    "identity": "identity",
}


def model_adjtype(model_cfg) -> str:
    """The adjtype a ModelConfig's st-GNN diffuses over: DCRNN's by its
    filter_type, Graph WaveNet's by gwnet.adjtype."""
    if model_cfg.st_gnn == "dcrnn":
        return DCRNN_ADJTYPES[model_cfg.dcrnn.filter_type]
    return model_cfg.gwnet.adjtype


def n_static_supports(adjtype: str) -> int:
    """How many static supports `adjtype` builds (the Graph WaveNet's
    diffusion weights are sized by it)."""
    return len(build_supports(np.zeros((1, 1), np.float32), adjtype))


def synthetic_adjacency(n: int, seed: int = 0, density: float = 0.15) -> np.ndarray:
    """Random symmetric binary contiguity matrix for small-N stores."""
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.float32)
    a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    return a


def _norm_county(name: str) -> str:
    return name.lower().replace(" ", "_").replace(".", "").replace("-", "_")


def static_supports(
    n_counties: int,
    adjtype: str = "identity",
    county_names: List[str] | None = None,
    path: str | None = None,
    seed: int = 42,
) -> np.ndarray:
    """[S, N, N] float32 static supports: the Florida asset for 67
    counties, a synthetic graph for small test stores (the JAX package's
    train/loop.py:build_supports). With a non-identity adjtype the store's
    county order must match the CSV's, or each county would silently get
    another county's neighbours."""
    if n_counties == 67:
        names, adj = load_adjacency_csv(path)
        if county_names is not None and adjtype != "identity":
            if [_norm_county(n) for n in names] != [
                _norm_county(n) for n in county_names
            ]:
                raise ValueError(
                    "store county order does not match the adjacency CSV; "
                    "reorder the store or supply a matching adjacency CSV"
                )
    else:
        adj = synthetic_adjacency(n_counties, seed=seed)
    return np.stack(build_supports(adj, adjtype))


def model_supports(
    model_cfg,
    n_counties: int,
    county_names: List[str] | None = None,
    path: str | None = None,
    seed: int = 42,
) -> np.ndarray:
    """[S, N, N] static supports of a ModelConfig's st-GNN (the JAX
    package's train/loop.py:100-132 build_supports): static_supports at
    model_adjtype(model_cfg), with the same county-order check."""
    return static_supports(n_counties, model_adjtype(model_cfg), county_names, path, seed)


def config_supports(cfg, store) -> np.ndarray:
    """The supports that fit, predict and serve build for a Config over a
    store: model_supports at cfg.adjacency_csv and cfg.train.seed (the
    seed draws the synthetic graph of a store with fewer than 67
    counties, as in the JAX package's train/loop.py:130)."""
    return model_supports(cfg.model, store.n_counties, store.county_names,
                          path=cfg.adjacency_csv, seed=cfg.train.seed)
