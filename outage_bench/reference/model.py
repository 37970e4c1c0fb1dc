"""The plain reference of the fusion model: U-Net contraction -> bottleneck
encoder (+ Date2Vec) -> st-GNN -> bottleneck decoder -> U-Net expansion,
over [B, N, T, H, W, C].

Plain PyTorch in float32, written from the model's equations: it imports
nothing of the program under test and works everything out again from the
variables tree (flax key paths, Dense kernels [in, out], conv kernels HWIO,
ConvTranspose kernels [kh, kw, in, out]) and the inputs. Run it with TF32
off (`tf32_off`). `quant` is applied to both operands of every product of
the compute-dtype parts (every layer but Date2Vec): identity for the
reference, `bf16` for the rounding yardstick, `fp8` for the
lower-precision control.

Train mode normalizes each BatchNorm group (a (sample, county) pair in the
U-Net) by its own statistics and draws dropout from `drop`, a callable
that gets each dropout site's activation in the program's order and
returns it masked.

The st-GNN is a family of its own, one file each: st_gnn/<name>.py, found
by the configuration's "st_gnn" (`family`). A family file imports this
module for the shared parts and exposes:

  forward(z, params, stats, supports, cfg, train, drop, q, teacher)
      z [B, N, T, F + E] (bottleneck features and Date2Vec) ->
      [B, N, T, F]; params / stats the "st_gnn" subtrees (stats {} where
      the family keeps none); teacher None, or in a train step with
      scheduled sampling {"latent": [B, N, T, F] targets, "heads": one
      coin a step}
  layout(model, n, n_static)
      (path, shape, kind) of its leaves under params/st_gnn and
      batch_stats/st_gnn, in the program's order (`dense_leaves`,
      `bn_leaves`; kinds as in inputs.variables_layout)
  support_kind(model)
      the static supports it reads: "identity", "transition" or
      "doubletransition"
  dropout_sites(model, b, n, t)
      (shape, rate) of its dropout draws of a train forward, in order
  teacher(model)
      (p0, tau) of its scheduled sampling (the program's teacher-forcing
      probability and decay steps), or None where it has none or it is off
  MIX_KEYS
      the dotted keys of the model group that a traffic mix may set (its
      training knobs, such as a scheduled-sampling rate); () where none
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import math
import os
import re
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Quant = Callable[[torch.Tensor], torch.Tensor]
EPS = 1e-5


def ident(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor (amax to 448), gradients passed
    straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-12)
    q = (t.detach() * (448.0 / amax)).to(torch.float8_e4m3fn).float() * (amax / 448.0)
    return t + (q - t).detach()


def bf16(t: torch.Tensor) -> torch.Tensor:
    """bfloat16 operands, products accumulated in float32: the rounding the
    configuration's compute dtype puts on a product's inputs, a yardstick
    of how far this seed's weights amplify rounding."""
    return t + (t.detach().to(torch.bfloat16).float() - t.detach())


@contextlib.contextmanager
def tf32_off():
    """Full float32 products on the card (no TF32), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def dense(x, p, q: Quant, act: bool = False):
    y = q(x) @ q(p["kernel"]) + p["bias"]
    return torch.relu(y) if act else y


def conv3x3(x, kernel, q: Quant):
    """SAME 3x3 correlation, stride 1, no bias: [..., H, W, Cin] -> [..., H, W, C]."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = F.conv2d(q(x).reshape(-1, h, w, c).permute(0, 3, 1, 2),
                 q(kernel).permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).reshape(*lead, h, w, -1)


def batch_norm(x, p, s, train: bool, group_axes: int, record: Optional[List] = None):
    """Train: each group of the leading `group_axes` axes by its own biased
    statistics over the rest; eval: the running statistics. In train mode
    `record` (a list) gets (s, the groups' means, biased variances, count)."""
    if not train:
        return (x - s["mean"]) / torch.sqrt(s["var"] + EPS) * p["scale"] + p["bias"]
    g = math.prod(x.shape[:group_axes])
    xg = x.reshape(g, -1, x.shape[-1])
    mean = xg.mean(1, keepdim=True)
    var = (xg - mean).square().mean(1, keepdim=True)
    if record is not None:
        record.append((s, mean.detach(), var.detach(), xg.shape[1]))
    return ((xg - mean) / torch.sqrt(var + EPS) * p["scale"] + p["bias"]).reshape(x.shape)


def double_conv(x, p, s, train: bool, q: Quant, record: Optional[List] = None):
    x = torch.relu(batch_norm(conv3x3(x, p["conv1"]["kernel"], q), p["bn1"], s["bn1"], train, 2,
                              record))
    return torch.relu(batch_norm(conv3x3(x, p["conv2"]["kernel"], q), p["bn2"], s["bn2"], train,
                                 2, record))


def max_pool(x):
    """2x2 max over H, W of [..., H, W, C]."""
    *lead, h, w, c = x.shape
    return x.reshape(*lead, h // 2, 2, w // 2, 2, c).amax(dim=(-4, -2))


def conv_transpose(x, p, q: Quant):
    """flax ConvTranspose 2x2, stride 2, VALID: a correlation over the
    stride-dilated input, so output pixel (2i + a, 2j + b) takes
    x[i, j] . kernel[1 - a, 1 - b]."""
    *lead, h, w, _ = x.shape
    k = q(p["kernel"]).flip(0, 1)  # [a, b, cin, cout]
    y = torch.einsum("...ijc,abco->...iajbo", q(x), k)
    return y.reshape(*lead, 2 * h, 2 * w, k.shape[-1]) + p["bias"]


def date2vec(date_feats, p):
    x = date_feats.float()
    return torch.cat([x @ p["fc1"]["kernel"] + p["fc1"]["bias"],
                      torch.sin(x @ p["fc2"]["kernel"] + p["fc2"]["bias"])], -1)


def diffuse(x, a, q: Quant):
    """out[b, w, ..., c] = sum_v a[v, w] x[b, v, ..., c] over the node axis 1."""
    return torch.einsum("bv...,vw->bw...", q(x), q(a))


def running_stats(record: List, momentum: float = 0.1) -> None:
    """The BatchNorm running statistics after a train pass, in place, from
    its `record` in order: for each group k, r <- (1 - m) r + m s_k, of the
    group's mean and unbiased variance (torch's EMA, one update a group,
    groups in C order), in closed form: r <- (1 - m)^G r + sum_k
    m (1 - m)^(G - 1 - k) s_k."""
    for s, mean, var, m in record:
        g, c = mean.shape[0], mean.shape[-1]
        w = momentum * (1 - momentum) ** torch.arange(g - 1, -1, -1, dtype=torch.float32,
                                                      device=mean.device)
        decay = (1 - momentum) ** g
        s["mean"] = decay * s["mean"] + w @ mean.reshape(g, c)
        s["var"] = decay * s["var"] + w @ (var * (m / (m - 1))).reshape(g, c)


# --- the variables tree's leaves ------------------------------------------------

def dense_leaves(path: str, cin: int, cout: int, kind: str = "w") -> List[tuple]:
    """A Dense layer's kernel [cin, cout] and zero bias under params/path."""
    return [(f"params/{path}/kernel", (cin, cout), f"{kind}:{cin}"),
            (f"params/{path}/bias", (cout,), "zero")]


def bn_leaves(path: str, c: int) -> List[tuple]:
    """A BatchNorm's scale and shift under params/path, its running
    statistics under batch_stats/path."""
    return ([(f"params/{path}/{leaf}", (c,), f"bn_{leaf}") for leaf in ("scale", "bias")]
            + [(f"batch_stats/{path}/{leaf}", (c,), f"bn_{leaf}") for leaf in ("mean", "var")])


# --- the st-GNN families ----------------------------------------------------------

FAMILIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "st_gnn")


def family(cfg: Dict):
    """The st-GNN family module of the model group `cfg`:
    FAMILIES/<cfg["st_gnn"]>.py, loaded by path."""
    name = cfg["st_gnn"]
    if not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise ValueError(f"st_gnn {name!r} is not a family name (letters, digits, _)")
    path = os.path.join(FAMILIES, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"st_gnn {name!r}: no family file {path}")
    return _load(path)


@functools.lru_cache(maxsize=None)
def _load(path: str):
    name = "outage_bench_st_gnn_" + re.sub(r"\W", "_", os.path.splitext(path)[0])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def teacher(cfg: Dict):
    """(p0, tau) of the st-GNN's scheduled sampling, or None."""
    return family(cfg).teacher(cfg)


# --- the model ----------------------------------------------------------------------

def contraction(x, cp, cs, depth: int, train: bool, q: Quant, record: Optional[List] = None):
    """The U-Net contraction: (the bottleneck, the skips)."""
    y = double_conv(x, cp["inc"], cs["inc"], train, q, record)
    skips = [y]
    for i in range(1, depth + 1):
        y = double_conv(max_pool(y), cp[f"down{i}"]["conv"], cs[f"down{i}"]["conv"], train, q,
                        record)
        if i < depth:
            skips.append(y)
    return y, skips


def teacher_latent(variables: Dict, y, cfg: Dict, quant: Quant = ident):
    """The latent targets of scheduled sampling: the future frames y
    [B, N, horizon, H, W, Cin] through the shared contraction and bottleneck
    encoder in eval mode (running BatchNorm statistics, no dropout) ->
    [B, N, horizon, F]."""
    p, bs = variables["params"], variables["batch_stats"]
    b, n, t = y.shape[:3]
    z, _ = contraction(y.float(), p["contraction"], bs["contraction"], cfg["depth"], False, quant)
    zf = dense(z.reshape(b, n, t, -1), p["encoder"]["fc1"], quant, act=True)
    return dense(zf, p["encoder"]["fc2"], quant, act=True)


def forward(variables: Dict, x, date_feats, supports, cfg: Dict, train: bool = False,
            drop: Optional[Callable] = None, quant: Quant = ident, teacher: Optional[Dict] = None):
    """x [B, N, T, H, W, Cin] normalized frames, date_feats [B, T, 6] raw
    (0, 0, 0, y, m, d), supports [S, N, N] static supports -> the forecast
    [B, N, horizon, H, W, Cout], all float32. cfg is the configuration's
    "model" group; teacher (train mode only) goes to the st-GNN."""
    p, bs = variables["params"], variables["batch_stats"]
    q = quant
    depth = cfg["depth"]
    b, n, t = x.shape[:3]
    x = x.float()
    y, skips = contraction(x, p["contraction"], bs["contraction"], depth, train, q)
    zf = dense(y.reshape(b, n, t, -1), p["encoder"]["fc1"], q, act=True)
    if train:
        zf = drop(zf)
    zf = dense(zf, p["encoder"]["fc2"], q, act=True)
    te = date2vec(date_feats, p["date2vec"])[:, None].expand(b, n, t, -1)
    z = torch.cat([zf, te], -1)
    z = family(cfg).forward(z, p["st_gnn"], bs.get("st_gnn", {}), supports, cfg, train, drop, q,
                            teacher)
    dd = dense(z, p["decoder"]["fc1"], q, act=True)
    if train:
        dd = drop(dd)
    dd = dense(dd, p["decoder"]["fc2"], q, act=True)
    grid = x.shape[3] // 2**depth
    y = dd.reshape(b, n, z.shape[2], grid, grid, -1)
    ep, es = p["expansion"], bs["expansion"]
    for i in range(1, depth + 1):
        up = conv_transpose(y, ep[f"up{i}"]["up"], q)
        y = double_conv(torch.cat([skips[-i], up], -1), ep[f"up{i}"]["conv"],
                        es[f"up{i}"]["conv"], train, q)
    oc = ep["outc"]["conv"]
    return q(y) @ q(oc["kernel"][0, 0]) + oc["bias"]
