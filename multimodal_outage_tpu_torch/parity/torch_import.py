"""Reference PyTorch/Lightning checkpoints into the port (the port's own
copy of the JAX package's parity/torch_import.py).

A Lightning checkpoint written by the reference trainer (reference
lit.py:187-196, restored at lit.py:82 / tlit.py:49) converts into a
checkpoint directory of the port (core/checkpoint.py) that `evaluate`,
`serve --checkpoint_path` and `train --resume` read.

Key names (the reference module attribute layout, which is its
checkpoint's serialization interface):
  * Lightning wraps the model as `self.model` (reference lit.py:23), so
    every key carries a `model.` prefix; bare Modified_UNET state_dicts
    (no prefix) are accepted too.
  * DoubleConv is an nn.Sequential `double_conv` = [conv, bn, relu, conv,
    bn, relu] (reference models/unet.py:43-49): indices 0/1/3/4.
  * Down wraps [MaxPool2d, DoubleConv] as `maxpool_conv`
    (models/unet.py:59), Up holds `up` (ConvTranspose2d) + `conv`
    (DoubleConv) (models/unet.py:71-72), OutConv holds `conv`
    (models/unet.py:89).
  * Graph WaveNet: ModuleLists filter_convs/gate_convs/residual_convs/
    skip_convs/bn/gconv plus start_conv, end_conv_1/2, nodevec1/2
    (reference models/graph_wavenet.py:110-134,150-182); gconv's 1×1 mlp
    nests as `gconv.{i}.mlp.mlp` (graph_wavenet.py:71-81). residual_convs
    are built unconditionally but unused on the gcn path
    (graph_wavenet.py:159,239-245), so they may be absent from the tree.
  * Date2Vec ships as a separate whole-module torch pickle (reference
    date2vec.py:4-10, utils.py:108-109) with Linears fc1..fc5
    (date2vec.py:23-37); the fusion model uses the encode pair fc1/fc2
    (date2vec.py:49-52).

Layouts (torch → the port's tree, which keeps flax's): Conv2d OIHW →
HWIO; Linear [out, in] → Dense kernel [in, out]; 1×1 Conv2d → Dense
kernel [in, out]; 1×K temporal Conv2d → [K, in, out]; ConvTranspose2d
[in, out, kh, kw] → [kh, kw, in, out] flipped in both spatial axes
(weights.conv_transpose_weight flips it back for F.conv_transpose2d);
BatchNorm weight/bias/running_mean/running_var → params scale/bias +
batch_stats mean/var.

export_state_dict is the exact inverse. Both directions come from one
rule table built off the template tree, so they cannot drift apart.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from multimodal_outage_tpu_torch.weights import flatten, unflatten

Rule = Tuple[str, str, str, str]  # (collection, tree path, torch key, layout kind)

# layout kinds: torch array -> the tree's, and back
_FWD = {
    "direct": lambda w: w,
    "linear": lambda w: w.T,  # [out, in] -> [in, out]
    "conv": lambda w: w.transpose(2, 3, 1, 0),  # OIHW -> HWIO
    "conv1x1": lambda w: w[:, :, 0, 0].T,  # [out, in, 1, 1] -> [in, out]
    "conv1xk": lambda w: w[:, :, 0, :].transpose(2, 1, 0),  # -> [K, in, out]
    # torch's ConvTranspose2d is the gradient of a convolution; the tree
    # keeps flax's, a correlation over the dilated input: the same op only
    # with the kernel flipped spatially
    "convT": lambda w: w.transpose(2, 3, 0, 1)[::-1, ::-1],
}
_INV = {
    "direct": lambda w: w,
    "linear": lambda w: w.T,
    "conv": lambda w: w.transpose(3, 2, 0, 1),
    "conv1x1": lambda w: w.T[:, :, None, None],
    "conv1xk": lambda w: w.transpose(2, 1, 0)[:, :, None, :],
    "convT": lambda w: w[::-1, ::-1].transpose(2, 3, 0, 1),
}

DCRNN_ERROR = (
    "no reference mapping for a DCRNN st-GNN: the reference never shipped "
    "DCRNN source (models/unet.py:13 imports it, .gitignore:17 excludes it), "
    "so no reference DCRNN checkpoints exist to import — only gwnet fusion "
    "checkpoints convert"
)
GMAN_ERROR = (
    "no reference mapping for a GMAN st-GNN: the reference has no GMAN (it is "
    "the port's own st-GNN), so no reference GMAN checkpoints exist to import"
)


def _to_np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _double_conv_rules(ours: str, theirs: str, collection: str) -> List[Rule]:
    """The rows of one DoubleConv block."""
    if collection == "params":
        rows = [("params", f"{ours}/conv{n}/kernel", f"{theirs}.{seq}.weight", "conv")
                for n, seq in ((1, 0), (2, 3))]
        for n, seq in ((1, 1), (2, 4)):
            rows.append(("params", f"{ours}/bn{n}/scale", f"{theirs}.{seq}.weight", "direct"))
            rows.append(("params", f"{ours}/bn{n}/bias", f"{theirs}.{seq}.bias", "direct"))
        return rows
    rows = []
    for n, seq in ((1, 1), (2, 4)):
        rows.append(("batch_stats", f"{ours}/bn{n}/mean", f"{theirs}.{seq}.running_mean",
                     "direct"))
        rows.append(("batch_stats", f"{ours}/bn{n}/var", f"{theirs}.{seq}.running_var",
                     "direct"))
    return rows


def _torch_dc_prefix(block_path: str) -> Optional[str]:
    """The tree's DoubleConv block path → the torch Sequential prefix."""
    if block_path == "contraction/inc":
        return "contraction.inc.double_conv"
    m = re.fullmatch(r"contraction/(down\d+)/conv", block_path)
    if m:
        return f"contraction.{m.group(1)}.maxpool_conv.1.double_conv"
    m = re.fullmatch(r"expansion/(up\d+)/conv", block_path)
    if m:
        return f"expansion.{m.group(1)}.conv.double_conv"
    return None


def _wb(leaf: str) -> str:
    return {"kernel": "weight", "bias": "bias"}[leaf]


def build_rules(variables: Dict[str, Any]) -> List[Rule]:
    """The (collection, tree path, torch key, kind) table of a template
    {"params", "batch_stats"} tree: every leaf but the date2vec subtree,
    which the reference keeps in a separate pickle."""
    st = variables.get("params", {}).get("st_gnn", {})
    if "spatial_embedding" in st:
        raise ValueError(GMAN_ERROR)
    if "encoder" in st or "decoder" in st:
        raise ValueError(DCRNN_ERROR)
    rules: List[Rule] = []
    seen = set()
    for collection in ("params", "batch_stats"):
        for path in flatten(variables.get(collection, {})):
            if path.startswith("date2vec/"):
                continue  # the separate .pth: date2vec_params_from_pth
            m = re.fullmatch(r"(.*)/(conv[12]|bn[12])/[a-z]+", path)
            if m and _torch_dc_prefix(m.group(1)):
                if (collection, m.group(1)) not in seen:
                    seen.add((collection, m.group(1)))
                    rules.extend(_double_conv_rules(m.group(1), _torch_dc_prefix(m.group(1)),
                                                    collection))
                continue
            m = re.fullmatch(r"expansion/(up\d+)/up/(kernel|bias)", path)
            if m:
                kind = "convT" if m.group(2) == "kernel" else "direct"
                rules.append((collection, path, f"expansion.{m.group(1)}.up.{_wb(m.group(2))}",
                              kind))
                continue
            m = re.fullmatch(r"expansion/outc/conv/(kernel|bias)", path)
            if m:
                kind = "conv" if m.group(1) == "kernel" else "direct"
                rules.append((collection, path, f"expansion.outc.conv.{_wb(m.group(1))}", kind))
                continue
            m = re.fullmatch(r"(encoder|decoder)/(fc[12])/(kernel|bias)", path)
            if m:
                kind = "linear" if m.group(3) == "kernel" else "direct"
                rules.append((collection, path,
                              f"{m.group(1)}.{m.group(2)}.{_wb(m.group(3))}", kind))
                continue
            if path.startswith("st_gnn/"):
                rules.append(_gwnet_rule(collection, path))
                continue
            raise ValueError(
                f"no reference mapping for {collection}:{path} — the torch importer only "
                "covers the gwnet fusion model (the reference never shipped DCRNN source, "
                "models/unet.py:13 / .gitignore:17)"
            )
    return rules


def _gwnet_rule(collection: str, path: str) -> Rule:
    sub = path[len("st_gnn/"):]
    # flat per-layer leaves of the fused path (kernel_size 1 with supports)
    m = re.fullmatch(r"(filter|gate|skip)_conv(\d+)_(kernel|bias)", sub)
    if m:
        kind = "conv1x1" if m.group(3) == "kernel" else "direct"
        return (collection, path, f"st_gnn.{m.group(1)}_convs.{m.group(2)}.{_wb(m.group(3))}",
                kind)
    m = re.fullmatch(r"gconv(\d+)_(kernel|bias)", sub)
    if m:
        kind = "conv1x1" if m.group(2) == "kernel" else "direct"
        return (collection, path, f"st_gnn.gconv.{m.group(1)}.mlp.mlp.{_wb(m.group(2))}", kind)
    # named modules of the other paths: filter/gate are 1×K temporal
    # convs, skip stays 1×1
    m = re.fullmatch(r"(filter|gate|skip)_conv(\d+)/(kernel|bias)", sub)
    if m:
        if m.group(3) != "kernel":
            kind = "direct"
        elif m.group(1) == "skip":
            kind = "conv1x1"
        else:
            kind = "conv1xk"
        return (collection, path, f"st_gnn.{m.group(1)}_convs.{m.group(2)}.{_wb(m.group(3))}",
                kind)
    m = re.fullmatch(r"residual_conv(\d+)/(kernel|bias)", sub)
    if m:
        kind = "conv1x1" if m.group(2) == "kernel" else "direct"
        return (collection, path, f"st_gnn.residual_convs.{m.group(1)}.{_wb(m.group(2))}",
                kind)
    m = re.fullmatch(r"(start_conv|end_conv_1|end_conv_2)/(kernel|bias)", sub)
    if m:
        kind = "conv1x1" if m.group(2) == "kernel" else "direct"
        return (collection, path, f"st_gnn.{m.group(1)}.{_wb(m.group(2))}", kind)
    m = re.fullmatch(r"bn(\d+)/(scale|bias|mean|var)", sub)
    if m:
        tk = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}[m.group(2)]
        return (collection, path, f"st_gnn.bn.{m.group(1)}.{tk}", "direct")
    if sub in ("nodevec1", "nodevec2"):
        return (collection, path, f"st_gnn.{sub}", "direct")
    raise ValueError(f"no reference mapping for gwnet param {path!r}")


def strip_lightning_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Accept LitModified_UNET checkpoints (keys under `model.`, reference
    lit.py:23) and bare Modified_UNET state_dicts."""
    if any(k.startswith("model.") for k in sd):
        return {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return dict(sd)


def import_state_dict(sd: Dict[str, Any], variables: Dict[str, Any],
                      strict: bool = True) -> Dict[str, Any]:
    """Map a reference state_dict onto a template {"params",
    "batch_stats"} tree (numpy or tensor leaves).

    Returns the tree with every mapped leaf replaced by the
    layout-transformed reference weight as a numpy array of the template
    leaf's dtype; the date2vec subtree keeps the template's (feed
    date2vec_params_from_pth through merge_date2vec). strict raises if a
    template leaf has no source key or a reference key goes unconsumed,
    BatchNorm num_batches_tracked counters and the dead residual_convs
    aside."""
    sd = {k: _to_np(v) for k, v in strip_lightning_prefix(sd).items()}
    rules = build_rules(variables)
    out = {c: {p: _to_np(v) for p, v in flatten(variables.get(c, {})).items()}
           for c in ("params", "batch_stats")}
    consumed = set()
    missing = []
    for collection, path, key, kind in rules:
        if key not in sd:
            missing.append(f"{collection}:{path} <- {key}")
            continue
        w = _FWD[kind](sd[key])
        tmpl = out[collection][path]
        if tuple(w.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"shape mismatch importing {key} -> {path}: torch {tuple(sd[key].shape)} maps "
                f"to {tuple(w.shape)}, template expects {tuple(tmpl.shape)} — check the model "
                "flags (st_gnn/horizon/channels) match the checkpoint's"
            )
        out[collection][path] = w.astype(tmpl.dtype)
        consumed.add(key)
    if strict and missing:
        raise ValueError("reference checkpoint is missing keys for: " + ", ".join(missing))
    leftovers = [k for k in sd if k not in consumed and not k.endswith("num_batches_tracked")
                 and not k.startswith("st_gnn.residual_convs.")]
    if strict and leftovers:
        raise ValueError("unconsumed reference keys (wrong architecture flags?): "
                         + ", ".join(sorted(leftovers)[:12]))
    return {c: unflatten(f) for c, f in out.items()}


def export_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The inverse of import_state_dict: a tree → a reference-named,
    torch-layout numpy state_dict (without the BatchNorm counters and the
    dead residual_convs; load it into the reference modules with
    strict=False)."""
    flat = {c: flatten(variables.get(c, {})) for c in ("params", "batch_stats")}
    # contiguous: the convT flip is a negative-strided view, which
    # torch.from_numpy refuses
    return {key: np.ascontiguousarray(_INV[kind](_to_np(flat[collection][path])))
            for collection, path, key, kind in build_rules(variables)}


def merge_date2vec(params: Dict[str, Any], d2v: Dict[str, Any]) -> Dict[str, Any]:
    """Replace the date2vec/fc1, fc2 leaves (the encode pair of the
    fusion forward, reference date2vec.py:49-52) with imported weights,
    cast to the template's dtype."""
    flat = flatten(params)
    for fc in ("fc1", "fc2"):
        for leaf in ("kernel", "bias"):
            path = f"date2vec/{fc}/{leaf}"
            if path not in flat:
                raise ValueError(f"template has no {path}")
            w, tmpl = np.asarray(d2v[fc][leaf]), _to_np(flat[path])
            if tuple(w.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"date2vec shape mismatch at {path}: pth gives {tuple(w.shape)}, template "
                    f"expects {tuple(tmpl.shape)} (k must match time_embed_size; the shipped "
                    "reference checkpoint was k=64, SURVEY C3)"
                )
            flat[path] = w.astype(tmpl.dtype)
    return unflatten(flat)


def date2vec_params_from_pth(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """The fc1/fc2 {"kernel" [in, out], "bias"} of a reference Date2Vec
    checkpoint (*.pth): a plain state_dict or the reference's whole-module
    pickle (reference date2vec.py:6 `torch.load(model_path)`). A module
    pickle names its class by import path; _register_date2vec_shim makes
    those names resolve without the reference on sys.path."""
    import torch

    _register_date2vec_shim()
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj if isinstance(obj, dict) else obj.state_dict()
    sd = {k: _to_np(v) for k, v in sd.items()}
    return {fc: {"kernel": sd[f"{fc}.weight"].T, "bias": sd[f"{fc}.bias"]}
            for fc in ("fc1", "fc2")}


def _register_date2vec_shim() -> None:
    """Register a Date2Vec class with the reference's attribute layout
    (fc1/fc2/d2/fc3/d3/fc4/fc5, date2vec.py:23-37) under the module names
    the reference used: date2vec, Model and model. A name already in
    sys.modules (the JAX package's shim, in a test process that loads
    both) keeps its class."""
    import sys
    import types

    import torch
    from torch import nn

    class Date2Vec(nn.Module):
        def __init__(self, k=32, act="sin"):
            super().__init__()
            k1 = k // 2
            k2 = k - k1
            self.fc1 = nn.Linear(6, k1)
            self.fc2 = nn.Linear(6, k2)
            self.d2 = nn.Dropout(0.3)
            self.activation = torch.sin if act == "sin" else torch.cos
            self.fc3 = nn.Linear(k, k // 2)
            self.d3 = nn.Dropout(0.3)
            self.fc4 = nn.Linear(k // 2, 6)
            self.fc5 = nn.Linear(6, 6)

    # picklable under the name it loads by (torch.save of a shim module)
    Date2Vec.__module__ = "date2vec"
    Date2Vec.__qualname__ = "Date2Vec"
    for name in ("date2vec", "Model", "model"):
        mod = sys.modules.get(name)
        if mod is None:
            mod = types.ModuleType(name)
            sys.modules[name] = mod
        if not hasattr(mod, "Date2Vec"):
            mod.Date2Vec = Date2Vec


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference checkpoint file (a Lightning .ckpt dict with a
    "state_dict" entry, or a bare state_dict .pth) as a numpy dict.

    Loads with weights_only=True first, which runs no code from the file.
    Only when that refuses a global (pickle.UnpicklingError naming an
    "Unsupported global": a valid pickle of module classes) does it
    unpickle in full, which trusts the file. Any other error (I/O, a
    corrupt archive) propagates."""
    import pickle

    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if "Unsupported global" not in str(e):
            raise
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        obj = obj.state_dict()
    return {k: _to_np(v) for k, v in obj.items()}


def convert_checkpoint(cfg, checkpoint_path: str, out_dir: str, d2v_pth: Optional[str] = None,
                       strict: bool = True, device=None) -> Dict[str, int]:
    """A reference .ckpt/.pth → a checkpoint directory of the port at
    out_dir (JAX parity/torch_import.py:466-540), without a data store.

    The template is train/loop.py's initial variables (cfg.train.seed, the
    --d2v_bundle's Date2Vec) at cfg.data.n_counties counties. The imported
    tree is loaded into a ModifiedUNet on `device` (default cuda), so a
    tree that does not fit the model fails here. The checkpoint is the
    whole training tree: params, batch_stats, a fresh Adam (count 0),
    step 0 and the early-stopping meta (epoch 0, best_val inf, best_epoch
    -1, bad_epochs 0), saved at step 0 with val_loss 1e30: the index is
    JSON, which holds no inf, and the first real validation sweep of a
    resumed run demotes it. Returns {"leaves", "torch_keys"}."""
    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
    from multimodal_outage_tpu_torch.core.device import resolve_device
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.train.loop import _ckpt_tree, _initial_variables
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.weights import load_variables

    dev = resolve_device(device)  # fail before any work
    n = cfg.data.n_counties
    static = model_supports(cfg.model, n, path=cfg.adjacency_csv, seed=cfg.train.seed)
    template = _initial_variables(cfg, n, static)
    sd = load_torch_checkpoint(checkpoint_path)
    imported = import_state_dict(sd, template, strict=strict)
    if d2v_pth:
        imported["params"] = merge_date2vec(imported["params"],
                                            date2vec_params_from_pth(d2v_pth))
    model = build_model(cfg.model, cfg.data.horizon, n, cfg.data.image_size)
    load_variables(model, imported)
    model.to(dev)
    state = create_train_state(model)
    CheckpointManager(out_dir).save(0, _ckpt_tree(state, 0, float("inf"), -1, 0),
                                    metrics={"val_loss": 1e30})
    leaves = len(flatten(imported["params"])) + len(flatten(imported["batch_stats"]))
    return {"leaves": leaves, "torch_keys": len(sd)}
