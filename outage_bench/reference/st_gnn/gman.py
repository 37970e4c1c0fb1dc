"""GMAN (Zheng, Fan, Wang, Qi, AAAI 2020, arXiv:1911.08415; the authors'
model.py): spatial, causal temporal and transform attention with gated
fusion, over z [B, N, P, F + E] -> [B, N, Q, F].

FC_a(x) = a(BN(x W + b)), the bias before the BatchNorm; FC2[u1, u2] is
FC_relu then FC_none. BN per channel: train mode by the biased statistics
over every (b, n, t) row, eval mode by the running statistics. D = K d.

  input      H = FC2[D, D](z)
  STE        SE = FC2[D, D](S), TE = FC2[D, D](onehot(step)) over the
             P + Q steps, E = SE + TE [N, P + Q, D]: E_P, E_Q
  ST block   X = [H, E]; q, k, v = FC_relu(X) of width D, K heads of d;
             spatial: softmax(q k^T / sqrt d) v over the N counties of each
             (b, t, head); temporal: over the T steps of each (b, n, head),
             a score of step j > i set to -2^15 + 1 (the authors' mask);
             heads joined, FC2[D, D] each: HS, HT;
             g = sigmoid(FC_none,no bias(HS) + FC_none(HT)),
             H + FC2[D, D](g HS + (1 - g) HT)
  encoder    L blocks with E_P
  transform  q = FC_relu(E_Q), k = FC_relu(E_P), v = FC_relu(H): Q steps
             over P steps, no mask; FC2[D, D]
  decoder    L blocks with E_Q
  output     FC2[D, F]

E is computed on every call. Departures from the authors' model, as the
program has them: TE one-hot encodes the step's position in the window
(the calendar comes in through Date2Vec in z); S is a fixed N(0, 1) array
of the variables tree, not node2vec (no word2vec trainer here; the forward
is the same either way); the running statistics' decay is the repo's.
GMAN has no dropout and reads no static support.

An st-GNN family of the plain reference (reference/model.py says what a
family file exposes).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from outage_bench.reference import model as ref

MIX_KEYS = ()  # no training knob a traffic mix may set
MASKED = -(2.0 ** 15) + 1


def support_kind(model: Dict) -> str:
    return "identity"


def teacher(model: Dict) -> None:
    return None


def dropout_sites(model: Dict, b: int, n: int, t: int) -> List[Tuple[tuple, float]]:
    """None: GMAN has no dropout."""
    return []


def _width(model: Dict) -> int:
    g = model["gman"]
    return g["num_heads"] * g["head_dim"]


def layout(model: Dict, n: int, n_static: int) -> List[Tuple[str, tuple, str]]:
    w, fvs = _width(model), model["feature_vector_size"]
    out = [("params/st_gnn/spatial_embedding", (n, w), "node")]

    def fc(path, cin, cout, bias=True):
        leaves = ref.dense_leaves(path, cin, cout)
        out.extend(leaves if bias else leaves[:1])
        out.extend(ref.bn_leaves(f"{path}/bn", cout))

    def fc2(path, cin, cout):
        fc(f"{path}/fc1", cin, w)
        fc(f"{path}/fc2", w, cout)

    def attention(path, cin):
        for name in ("query", "key", "value"):
            fc(f"{path}/{name}", cin, w)
        fc2(f"{path}/out", w, w)

    def blocks(part):
        for l in range(model["gman"]["num_blocks"]):
            base = f"st_gnn/{part}/block{l}"
            attention(f"{base}/spatial", 2 * w)
            attention(f"{base}/temporal", 2 * w)
            fc(f"{base}/fusion/xs", w, w, bias=False)
            fc(f"{base}/fusion/xt", w, w)
            fc2(f"{base}/fusion/out", w, w)

    fc2("st_gnn/input", fvs + model["time_embed_size"], w)
    fc2("st_gnn/se", w, w)
    fc2("st_gnn/te", model["gman"]["steps"], w)
    blocks("encoder")
    attention("st_gnn/transform", w)
    blocks("decoder")
    fc2("st_gnn/output", w, fvs)
    return out


def forward(z, st, sbs, supports, cfg, train: bool, drop, q: ref.Quant,
            teacher: Optional[Dict] = None):
    heads = cfg["gman"]["num_heads"]

    def fc(x, p, s, relu):
        y = q(x) @ q(p["kernel"])
        if "bias" in p:
            y = y + p["bias"]
        y = ref.batch_norm(y, p["bn"], s["bn"], train, 0)
        return torch.relu(y) if relu else y

    def fc2(x, p, s):
        return fc(fc(x, p["fc1"], s["fc1"], True), p["fc2"], s["fc2"], False)

    def attend(qx, kx, vx, mask=None):
        """[..., L, d] queries over [..., S, d] keys and values."""
        score = q(qx) @ q(kx).transpose(-1, -2) / math.sqrt(qx.shape[-1])
        if mask is not None:
            score = score.masked_fill(~mask, MASKED)
        return q(torch.softmax(score, -1)) @ q(vx)

    def split(x):
        """[..., D] -> [..., K, d]."""
        return x.reshape(*x.shape[:-1], heads, x.shape[-1] // heads)

    def block(h, e, p, s):
        x = torch.cat([h, e.expand(h.shape[0], -1, -1, -1)], -1)  # [B, N, T, 2D]
        t = x.shape[2]
        qkv = {}
        for kind in ("spatial", "temporal"):
            qkv[kind] = [split(fc(x, p[kind][name], s[kind][name], True))
                         for name in ("query", "key", "value")]  # [B, N, T, K, d]
        # spatial: each (b, t, head) over N
        qs, ks, vs = (a.permute(0, 2, 3, 1, 4) for a in qkv["spatial"])
        hs = attend(qs, ks, vs).permute(0, 3, 1, 2, 4).flatten(-2)
        hs = fc2(hs, p["spatial"]["out"], s["spatial"]["out"])
        # temporal: each (b, n, head) over T, causal
        qt, kt, vt = (a.permute(0, 1, 3, 2, 4) for a in qkv["temporal"])
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        ht = attend(qt, kt, vt, causal).permute(0, 1, 3, 2, 4).flatten(-2)
        ht = fc2(ht, p["temporal"]["out"], s["temporal"]["out"])
        pf, sf = p["fusion"], s["fusion"]
        g = torch.sigmoid(fc(hs, pf["xs"], sf["xs"], False) + fc(ht, pf["xt"], sf["xt"], False))
        return h + fc2(g * hs + (1 - g) * ht, pf["out"], sf["out"])

    b, n, p_in, _ = z.shape
    se = fc2(st["spatial_embedding"], st["se"], sbs["se"])  # [N, D]
    steps = st["te"]["fc1"]["kernel"].shape[0]
    te = fc2(torch.eye(steps, device=z.device), st["te"], sbs["te"])  # [P + Q, D]
    e = se[:, None] + te[None]  # [N, P + Q, D]
    ep, eq = e[:, :p_in], e[:, p_in:]
    h = fc2(z, st["input"], sbs["input"])
    for l in range(cfg["gman"]["num_blocks"]):
        h = block(h, ep, st["encoder"][f"block{l}"], sbs["encoder"][f"block{l}"])
    tp, ts = st["transform"], sbs["transform"]
    qx = split(fc(eq, tp["query"], ts["query"], True)).transpose(1, 2)  # [N, K, Q, d]
    kx = split(fc(ep, tp["key"], ts["key"], True)).transpose(1, 2)  # [N, K, P, d]
    vx = split(fc(h, tp["value"], ts["value"], True)).transpose(2, 3)  # [B, N, K, P, d]
    h = attend(qx.expand(b, -1, -1, -1, -1), kx.expand(b, -1, -1, -1, -1), vx)
    h = fc2(h.transpose(2, 3).flatten(-2), tp["out"], ts["out"])  # [B, N, Q, D]
    for l in range(cfg["gman"]["num_blocks"]):
        h = block(h, eq, st["decoder"][f"block{l}"], sbs["decoder"][f"block{l}"])
    return fc2(h, st["output"], sbs["output"])
