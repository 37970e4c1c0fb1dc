"""Graph WaveNet, the fused kernel_size-1 path: per layer the gated unit
g = tanh(x Wf + bf) * sigmoid(x Wg + bg), skip s = g Ws + bs, diffusion
h = [g, A g, A^2 g, ...] Wc + bc over every support (the static ones and
the adaptive softmax(relu(E1 E2))), dropout, residual, BatchNorm per sample
over (N, T); then relu(skip) -> end_conv_1 -> relu -> end_conv_2.

An st-GNN family of the plain reference (reference/model.py says what a
family file exposes).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from outage_bench.reference import model as ref

MIX_KEYS = ()  # no training knob a traffic mix may set


def _check(g: Dict) -> None:
    if g["kernel_size"] != 1 or not g["gcn_bool"] or g.get("reference_view_quirk"):
        raise NotImplementedError("the reference covers the fused Graph WaveNet path")


def support_kind(model: Dict) -> str:
    return model["gwnet"]["adjtype"]


def teacher(model: Dict) -> None:
    return None


def dropout_sites(model: Dict, b: int, n: int, t: int) -> List[Tuple[tuple, float]]:
    """Each layer's output."""
    g = model["gwnet"]
    return [((b, n, t, g["residual_channels"]), g["dropout"])] * (g["blocks"] * g["layers"])


def layout(model: Dict, n: int, n_static: int) -> List[Tuple[str, tuple, str]]:
    g = model["gwnet"]
    c, cd, cs, ce = (g["residual_channels"], g["dilation_channels"], g["skip_channels"],
                     g["end_channels"])
    _check(g)
    fvs = model["feature_vector_size"]
    adaptive = g["addaptadj"]
    nt = (n_static + int(adaptive)) * g["order"] + 1
    out = ref.dense_leaves("st_gnn/start_conv", fvs + model["time_embed_size"], c)
    if adaptive:
        out.append(("params/st_gnn/nodevec1", (n, g["node_embed_dim"]), "node"))
        out.append(("params/st_gnn/nodevec2", (g["node_embed_dim"], n), "node"))
    for i in range(g["blocks"] * g["layers"]):
        for name, (a, b) in (("filter_conv", (c, cd)), ("gate_conv", (c, cd)),
                             ("skip_conv", (cd, cs)), ("gconv", (nt * cd, c))):
            out.append((f"params/st_gnn/{name}{i}_kernel", (a, b), f"w:{a}"))
            out.append((f"params/st_gnn/{name}{i}_bias", (b,), "zero"))
        out += ref.bn_leaves(f"st_gnn/bn{i}", c)
    out += ref.dense_leaves("st_gnn/end_conv_1", cs, ce)
    out += ref.dense_leaves("st_gnn/end_conv_2", ce, fvs)
    return out


def adaptive_support(st):
    return torch.softmax(torch.relu(st["nodevec1"] @ st["nodevec2"]), dim=1)


def forward(z, st, sbs, supports, cfg, train: bool, drop, q: ref.Quant,
            teacher: Optional[Dict] = None):
    g = cfg["gwnet"]
    _check(g)
    sup = [a for a in supports]
    if g["addaptadj"]:
        sup.append(adaptive_support(st))
    x = ref.dense(z, st["start_conv"], q)
    skip = None
    for i in range(g["blocks"] * g["layers"]):
        w = lambda name: {"kernel": st[f"{name}{i}_kernel"], "bias": st[f"{name}{i}_bias"]}
        gate = torch.tanh(ref.dense(x, w("filter_conv"), q)) * torch.sigmoid(
            ref.dense(x, w("gate_conv"), q))
        s = ref.dense(gate, w("skip_conv"), q)
        terms = [gate]
        for a in sup:
            t = gate
            for _ in range(g["order"]):
                t = ref.diffuse(t, a, q)
                terms.append(t)
        h = ref.dense(torch.cat(terms, -1), w("gconv"), q)
        if train:
            h = drop(h)
        skip = s if skip is None else s + skip
        x = ref.batch_norm(h + x, st[f"bn{i}"], sbs[f"bn{i}"], train, 1)
    out = ref.dense(torch.relu(skip), st["end_conv_1"], q, act=True)
    return ref.dense(out, st["end_conv_2"], q)
