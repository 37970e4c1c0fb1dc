"""The plain reference of the fusion model: U-Net contraction -> bottleneck
encoder (+ Date2Vec) -> st-GNN (Graph WaveNet, fused kernel_size-1 path, or
DCRNN) -> bottleneck decoder -> U-Net expansion, over [B, N, T, H, W, C].

Plain PyTorch in float32, written from the model's equations: it imports
nothing of the program under test and works everything out again from the
variables tree (flax key paths, Dense kernels [in, out], conv kernels HWIO,
ConvTranspose kernels [kh, kw, in, out]) and the inputs. Run it with TF32
off (`tf32_off`). `quant` is applied to both operands of every product of
the compute-dtype parts (every layer but Date2Vec): identity for the
reference, `bf16` for the rounding yardstick, `fp8` for the
lower-precision control.

Train mode normalizes each BatchNorm group (a (sample, county) pair in the
U-Net, a sample in Graph WaveNet) by its own statistics and draws dropout
from `drop`, a callable that gets each dropout site's activation in the
program's order and returns it masked.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

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


def batch_norm(x, p, s, train: bool, group_axes: int):
    """Train: each group of the leading `group_axes` axes by its own biased
    statistics over the rest; eval: the running statistics."""
    if not train:
        return (x - s["mean"]) / torch.sqrt(s["var"] + EPS) * p["scale"] + p["bias"]
    g = math.prod(x.shape[:group_axes])
    xg = x.reshape(g, -1, x.shape[-1])
    mean = xg.mean(1, keepdim=True)
    var = (xg - mean).square().mean(1, keepdim=True)
    return ((xg - mean) / torch.sqrt(var + EPS) * p["scale"] + p["bias"]).reshape(x.shape)


def double_conv(x, p, s, train: bool, q: Quant):
    x = torch.relu(batch_norm(conv3x3(x, p["conv1"]["kernel"], q), p["bn1"], s["bn1"], train, 2))
    return torch.relu(batch_norm(conv3x3(x, p["conv2"]["kernel"], q), p["bn2"], s["bn2"], train, 2))


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


def adaptive_support(st):
    return torch.softmax(torch.relu(st["nodevec1"] @ st["nodevec2"]), dim=1)


def diffuse(x, a, q: Quant):
    """out[b, w, ..., c] = sum_v a[v, w] x[b, v, ..., c] over the node axis 1."""
    return torch.einsum("bv...,vw->bw...", q(x), q(a))


def graph_wavenet(z, st, sbs, supports, cfg, train: bool, drop, q: Quant):
    """The fused Graph WaveNet (kernel_size 1): per layer the gated unit
    g = tanh(x Wf + bf) * sigmoid(x Wg + bg), skip s = g Ws + bs, diffusion
    h = [g, A g, A^2 g, ...] Wc + bc over every support, dropout, residual,
    BatchNorm per sample over (N, T); then relu(skip) -> end_conv_1 -> relu
    -> end_conv_2."""
    g = cfg["gwnet"]
    if g["kernel_size"] != 1 or not g["gcn_bool"] or g.get("reference_view_quirk"):
        raise NotImplementedError("the reference covers the fused Graph WaveNet path")
    sup = [a for a in supports]
    if g["addaptadj"]:
        sup.append(adaptive_support(st))
    x = dense(z, st["start_conv"], q)
    skip = None
    for i in range(g["blocks"] * g["layers"]):
        w = lambda name: {"kernel": st[f"{name}{i}_kernel"], "bias": st[f"{name}{i}_bias"]}
        gate = torch.tanh(dense(x, w("filter_conv"), q)) * torch.sigmoid(dense(x, w("gate_conv"), q))
        s = dense(gate, w("skip_conv"), q)
        terms = [gate]
        for a in sup:
            t = gate
            for _ in range(g["order"]):
                t = diffuse(t, a, q)
                terms.append(t)
        h = dense(torch.cat(terms, -1), w("gconv"), q)
        if train:
            h = drop(h)
        skip = s if skip is None else s + skip
        x = batch_norm(h + x, st[f"bn{i}"], sbs[f"bn{i}"], train, 1)
    out = dense(torch.relu(skip), st["end_conv_1"], q, act=True)
    return dense(out, st["end_conv_2"], q)


def dcrnn(z, st, supports, cfg, horizon: int, q: Quant):
    """Encoder-decoder of diffusion-convolutional GRU cells. A diffusion
    convolution projects [x, T_1(A)x, T_2(A)x, ...] per support, with
    T_1 = A x and T_k = 2 A T_{k-1} - T_{k-2}; the decoder starts from a
    zero GO symbol and feeds back its own projected output."""
    d = cfg["dcrnn"]
    k, units, layers = d["max_diffusion_step"], d["rnn_units"], d["num_rnn_layers"]

    def dconv(x, p):
        terms = [x]
        for a in supports:
            x0, x1 = x, diffuse(x, a, q)
            terms.append(x1)
            for _ in range(2, k + 1):
                x0, x1 = x1, 2.0 * diffuse(x1, a, q) - x0
                terms.append(x1)
        return dense(torch.cat(terms, -1), p["proj"], q)

    def cell(p, h, x):
        ru = torch.sigmoid(dconv(torch.cat([x, h], -1), p["gates"]))
        r, u = ru[..., :units], ru[..., units:]
        c = torch.tanh(dconv(torch.cat([x, r * h], -1), p["candidate"]))
        return u * h + (1.0 - u) * c

    b, n, t, _ = z.shape
    h = [z.new_zeros(b, n, units) for _ in range(layers)]
    for ti in range(t):
        inp = z[:, :, ti]
        for l in range(layers):
            h[l] = inp = cell(st["encoder"][f"cell{l}"], h[l], inp)
    prev = z.new_zeros(b, n, st["decoder"]["proj"]["kernel"].shape[1])
    outs = []
    for _ in range(horizon):
        inp = prev
        for l in range(layers):
            h[l] = inp = cell(st["decoder"][f"cell{l}"], h[l], inp)
        prev = dense(inp, st["decoder"]["proj"], q)
        outs.append(prev)
    return torch.stack(outs, dim=2)


def forward(variables: Dict, x, date_feats, supports, cfg: Dict, train: bool = False,
            drop: Optional[Callable] = None, quant: Quant = ident):
    """x [B, N, T, H, W, Cin] normalized frames, date_feats [B, T, 6] raw
    (0, 0, 0, y, m, d), supports [S, N, N] static supports -> the forecast
    [B, N, horizon, H, W, Cout], all float32. cfg is the configuration's
    "model" group."""
    p, bs = variables["params"], variables["batch_stats"]
    q = quant
    depth = cfg["depth"]
    b, n, t = x.shape[:3]
    x = x.float()
    cp, cs = p["contraction"], bs["contraction"]
    y = double_conv(x, cp["inc"], cs["inc"], train, q)
    skips = [y]
    for i in range(1, depth + 1):
        y = double_conv(max_pool(y), cp[f"down{i}"]["conv"], cs[f"down{i}"]["conv"], train, q)
        if i < depth:
            skips.append(y)
    zf = dense(y.reshape(b, n, t, -1), p["encoder"]["fc1"], q, act=True)
    if train:
        zf = drop(zf)
    zf = dense(zf, p["encoder"]["fc2"], q, act=True)
    te = date2vec(date_feats, p["date2vec"])[:, None].expand(b, n, t, -1)
    z = torch.cat([zf, te], -1)
    if cfg["st_gnn"] == "dcrnn":
        z = dcrnn(z, p["st_gnn"], supports, cfg, t, q)
    else:
        z = graph_wavenet(z, p["st_gnn"], bs["st_gnn"], supports, cfg, train, drop, q)
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
