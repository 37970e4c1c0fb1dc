"""What the benchmark makes from --seed and hands to both the program and
the reference: the frame store, the windows over it, the static supports
and the variables tree. Nothing here imports the program.

The store is a frozen copy of the program's synthetic Black Marble
generator (per-county "city light" blobs, hurricane outage dips with a
~10-day recovery, daily noise per county, the fill sentinel zeroed), drawn
on the device in a few large calls. The variables tree has the program's
layout (flax key paths and shapes of its init_variables) and the
distributions of flax's initializers, drawn on the device in one call.
"""

from __future__ import annotations

import csv
import datetime
import math
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from outage_bench.reference import model as ref

ADJ_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference", "adj_mx_fl.csv")


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


# --- the store --------------------------------------------------------------

def storm_dates(store: Dict) -> Dict[str, datetime.date]:
    return {k: datetime.date.fromisoformat(v) for k, v in store["storms"].items()}


def store_dates(store: Dict) -> np.ndarray:
    """[D, 3] (y, m, d) int32, the sorted union of +-margin days around each
    storm."""
    m = store["margin_days"]
    days = sorted({c + datetime.timedelta(days=d) for c in storm_dates(store).values()
                   for d in range(-m, m + 1)})
    return np.asarray([(d.year, d.month, d.day) for d in days], dtype=np.int32)


def make_frames(store: Dict, n: int, size: int, seed: int, device) -> torch.Tensor:
    """[D, N, H, W] float32 radiance on `device`."""
    g = generator(seed, 1, device)
    dates = store_dates(store)
    # per-county base: 2-5 gaussian blobs (6 drawn, the surplus masked)
    k = 6
    u = torch.rand((n, k, 5), generator=g, device=device)
    count = 2 + (u[:, 0, 4] * 4).long().clamp(max=3)
    live = torch.arange(k, device=device)[None] < count[:, None]
    cy, cx = u[..., 0], u[..., 1]
    sigma = 0.05 + 0.15 * u[..., 2]
    amp = (5.0 + 45.0 * u[..., 3]) * live
    yy = torch.arange(size, device=device, dtype=torch.float32) / size
    gy = torch.exp(-(yy[None, None] - cy[..., None]) ** 2 / (2 * sigma[..., None] ** 2))
    gx = torch.exp(-(yy[None, None] - cx[..., None]) ** 2 / (2 * sigma[..., None] ** 2))
    base = torch.einsum("nk,nky,nkx->nyx", amp, gy, gx)  # [N, H, W]
    # outage factor per (date, county): a dip after landfall, ~10-day recovery
    day_obj = [datetime.date(*map(int, r)) for r in dates]
    impact = torch.ones((len(dates), n), device=device)
    sens = 0.3 + 0.7 * torch.rand(n, generator=g, device=device)
    for c in storm_dates(store).values():
        dt = torch.tensor([(d - c).days for d in day_obj], device=device, dtype=torch.float32)
        hit = (dt >= 0).float()[:, None]
        impact = impact * (1.0 - hit * 0.8 * sens[None] * torch.exp(-dt.clamp(min=0) / 10.0)[:, None])
    noise = 1.0 + 0.1 * torch.randn((len(dates), n), generator=g, device=device)
    frames = base[None] * (impact * noise)[:, :, None, None]
    frames.clamp_(min=0.0)
    # the fill sentinel (6553.5) on ~0.1% of pixels, zeroed as the store does
    frames.masked_fill_(torch.rand(frames.shape, generator=g, device=device) < 1e-3, 0.0)
    return frames


def case_positions(dates: np.ndarray, cases: Dict[str, datetime.date], dataset_range: int) -> np.ndarray:
    """Positions into `dates` within +-dataset_range of each case date:
    python-slice semantics [p - r, p + r), union, sorted."""
    pos = {datetime.date(*map(int, r)): i for i, r in enumerate(dates)}
    sel = set()
    for c in cases.values():
        p = pos[c]
        sel.update(range(max(p - dataset_range, 0), min(p + dataset_range, len(dates))))
    return np.asarray(sorted(sel), dtype=np.int64)


def window_positions(positions: np.ndarray, idx: np.ndarray, horizon: int) -> np.ndarray:
    """[B, 2 horizon] frame positions of windows idx: past then future."""
    return positions[np.asarray(idx)[:, None] + np.arange(2 * horizon)[None]]


def reference_batch(frames: torch.Tensor, dates: np.ndarray, pos: np.ndarray, horizon: int,
                    mean: float, std: float, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The windows at `pos` as float32 model inputs: x, y [B, N, T, H, W, 1]
    normalized, date_feats [B, T, 6] = (0, 0, 0, y, m, d) of the past days.
    The normalization constants are held in the compute dtype `dtype`, as
    the model's input pipeline holds them; the arithmetic is float32."""
    mean, std = (float(torch.tensor(v, dtype=dtype)) for v in (mean, std))
    raw = frames[torch.from_numpy(pos.reshape(-1)).to(frames.device)]
    raw = raw.reshape(pos.shape[0], 2 * horizon, *frames.shape[1:]).float()
    norm = ((raw - mean) / std).permute(0, 2, 1, 3, 4)[..., None]
    feats = np.zeros((pos.shape[0], horizon, 6), np.float32)
    feats[..., 3:] = dates[pos[:, :horizon]]
    return {"x": norm[:, :, :horizon].contiguous(), "y": norm[:, :, horizon:].contiguous(),
            "date_feats": torch.from_numpy(feats).to(frames.device)}


# --- supports ---------------------------------------------------------------

def florida_adjacency() -> Tuple[List[str], np.ndarray]:
    with open(ADJ_CSV, newline="") as f:
        rows = list(csv.reader(f))
    names = [h.strip() for h in rows[0][1:]]
    return names, np.asarray([[float(v) for v in r[1:]] for r in rows[1:]], np.float32)


def transition(adj: np.ndarray) -> np.ndarray:
    """Row-normalized D^-1 A (a row of zeros stays zero)."""
    a = adj.astype(np.float64)
    rs = a.sum(1)
    inv = np.where(rs > 0, 1.0 / np.where(rs > 0, rs, 1.0), 0.0)
    return (inv[:, None] * a).astype(np.float32)


def static_supports(kind: str, n: int) -> np.ndarray:
    """[S, N, N]: "identity" (the reference repo's doubletransition quirk,
    one identity), "transition" [D^-1 A], "doubletransition" [D^-1 A,
    D^-1 A^T], over the Florida county graph (its first n counties where
    a test config has fewer)."""
    if kind == "identity":
        return np.eye(n, dtype=np.float32)[None]
    adj = florida_adjacency()[1]
    if adj.shape[0] < n:
        raise ValueError(f"the Florida graph has {adj.shape[0]} counties, the config {n}")
    adj = adj[:n, :n]
    if kind == "transition":
        return transition(adj)[None]
    if kind == "doubletransition":
        return np.stack([transition(adj), transition(adj.T)])
    raise ValueError(f"unknown support kind {kind!r}")


def support_kind(model: Dict) -> str:
    """The static supports the model's st-GNN family reads."""
    return ref.family(model).support_kind(model)


# --- the variables tree -------------------------------------------------------

def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flatten(v, path) if isinstance(v, dict) else {path: v})
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# typical magnitudes of the raw (0, 0, 0, y, m, d) Date2Vec inputs; its
# kernels are scaled inversely so that the embedding is O(1)
D2V_SCALE = (1.0, 1.0, 1.0, 2000.0, 6.5, 15.5)


def variables_layout(model: Dict, n: int, size: int, n_static: int) -> List[Tuple[str, tuple, str]]:
    """(path, shape, kind) of every leaf of the program's variables tree
    (its weights.init_variables), the st-GNN's from its family file.
    kind: "w:<fan_in>" a lecun-normal kernel, "d2v:<fan_in>" a Date2Vec
    kernel, "zero", "one", "bn_scale", "bn_bias", "bn_mean", "bn_var",
    "node" an N(0, 1) node embedding."""
    out: List[Tuple[str, tuple, str]] = []

    def double_conv(path, cin, c):
        out.append((f"params/{path}/conv1/kernel", (3, 3, cin, c), f"w:{9 * cin}"))
        out.append((f"params/{path}/conv2/kernel", (3, 3, c, c), f"w:{9 * c}"))
        out.extend(ref.bn_leaves(f"{path}/bn1", c))
        out.extend(ref.bn_leaves(f"{path}/bn2", c))

    depth, base = model["depth"], model["base_channels"]
    double_conv("contraction/inc", model["input_channels"], base)
    ch = base
    for i in range(1, depth + 1):
        double_conv(f"contraction/down{i}/conv", ch, 2 * ch)
        ch *= 2
    grid = size // 2**depth
    flat = grid * grid * ch
    fvs, k = model["feature_vector_size"], model["time_embed_size"]
    out += ref.dense_leaves("encoder/fc1", flat, flat // model["compression_factor"])
    out += ref.dense_leaves("encoder/fc2", flat // model["compression_factor"], fvs)
    out += ref.dense_leaves("date2vec/fc1", 6, k // 2, "d2v")
    out += ref.dense_leaves("date2vec/fc2", 6, k // 2 + k % 2, "d2v")
    out += ref.family(model).layout(model, n, n_static)
    out += ref.dense_leaves("decoder/fc1", fvs, fvs * model["compression_factor"])
    out += ref.dense_leaves("decoder/fc2", fvs * model["compression_factor"], flat)
    skip = base * 2 ** (depth - 1)
    for i in range(1, depth + 1):
        out.append((f"params/expansion/up{i}/up/kernel", (2, 2, ch, ch // 2), f"w:{4 * ch}"))
        out.append((f"params/expansion/up{i}/up/bias", (ch // 2,), "zero"))
        double_conv(f"expansion/up{i}/conv", skip + ch // 2, skip)
        ch, skip = skip, skip // 2
    out.append(("params/expansion/outc/conv/kernel", (1, 1, ch, model["output_channels"]),
                f"w:{ch}"))
    out.append(("params/expansion/outc/conv/bias", (model["output_channels"],), "zero"))
    return out


def make_variables(model: Dict, n: int, size: int, n_static: int, seed: int, device) -> Dict:
    """The variables tree {"params", "batch_stats"} as float32 tensors on
    `device`: lecun-normal kernels (truncated at 2 sigma), zero biases,
    biases of kind "one" 1.0, N(0, 1) node embeddings, and BatchNorm scales,
    shifts and running statistics spread about their initial values, so
    that folding them matters."""
    layout = variables_layout(model, n, size, n_static)
    sizes = [math.prod(s) for _, s, _ in layout]
    z = torch.randn(sum(sizes), generator=generator(seed, 2, device), device=device)
    flat: Dict[str, torch.Tensor] = {}
    off = 0
    for (path, shape, kind), k in zip(layout, sizes):
        v = z[off:off + k].reshape(shape)
        off += k
        if ":" in kind:
            kind, fan = kind.split(":")
            fan = int(fan)
            v = v.clamp(-2.0, 2.0) * (1.0 / math.sqrt(fan) / 0.8796256610342398)
            if kind == "d2v":
                v = v / torch.tensor(D2V_SCALE, device=device)[:, None]
        elif kind == "zero":
            v = torch.zeros_like(v)
        elif kind == "one":
            v = torch.ones_like(v)
        elif kind == "bn_scale":
            v = 1.0 + 0.1 * v
        elif kind in ("bn_bias", "bn_mean"):
            v = 0.1 * v
        elif kind == "bn_var":
            v = torch.exp(0.2 * v)
        flat[path] = v.contiguous()
    return unflatten(flat)
