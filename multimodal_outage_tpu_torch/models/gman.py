"""GMAN, the third st-GNN: Zheng, Fan, Wang, Qi, "GMAN: A Graph
Multi-Attention Network for Traffic Prediction" (AAAI 2020,
arXiv:1911.08415), after the authors' model.py, over [B, N, P, F + E] →
[B, N, Q, F] with P = T input days and Q = horizon output days.

FC_a(x) = a(BN(x·W + b)): the bias before the BatchNorm, as the authors'
conv2d has it; FC²[u₁, u₂] is FC_relu then FC_none. BN is per channel,
over every (b, n, t) row in train mode, with the running statistics in
eval mode. D = K·d channels, K heads of d.

  input      H = FC²[D, D](z)
  STE        SE = FC²[D, D](S), TE = FC²[D, D](onehot(step)) over the
             P + Q steps of the window, E = SE + TE [N, P + Q, D];
             E_P its first P steps, E_Q its last Q
  ST block   X = [H ‖ E]; q, k, v = FC_relu(X) each, split into K heads
             spatial:  softmax(q·kᵀ/√d) v over the N counties of each
                       (b, t, head), heads joined, HS = FC²[D, D]
             temporal: the same over the T steps of each (b, n, head),
                       causal (step i sees steps ≤ i), HT = FC²[D, D]
             gated fusion: g = σ(FC_none,no bias(HS) + FC_none(HT)),
                       H + FC²[D, D](g⊙HS + (1 − g)⊙HT)
  encoder    L blocks with E_P
  transform  q = FC_relu(E_Q), k = FC_relu(E_P), v = FC_relu(H): the Q
             future steps attend over the P past steps of each
             (b, n, head), no mask; FC²[D, D]
  decoder    L blocks with E_Q
  output     FC²[D, F]

GMAN has no dropout. Departures from the authors' model:
  - TE one-hot encodes each of the P + Q steps' position, not day-of-week
    and time-of-day: the calendar reaches the model through Date2Vec in
    z, as in every st-GNN of this fusion model.
  - S, the spatial embedding [N, D], is a fixed array of the variables
    tree (params/st_gnn/spatial_embedding, random N(0, 1) at init): held
    in checkpoints, never moved by Adam (requires_grad False), standing
    where GMAN puts node2vec over the graph, which needs a word2vec
    trainer. The forward computation is the same either way.
  - The BatchNorm running statistics follow the repo's EMA (momentum 0.1
    of the unbiased variance), not the authors' decay schedule. A
    sample_weight row of 0 (a pad row under a mesh) is left out of the
    train statistics and of their EMA, and with a data axis the moments
    are summed over the data group, so a mesh step normalizes by the
    global batch as one device does.

Every attention runs through F.scaled_dot_product_attention (the
temporal one with is_causal=True), and is counted by kind in
attention.calls as Python issues it (a CUDA graph's replays are not
counted). The module trains by autograd in the compute dtype with
float32 parameters; the serving engine runs FoldedGMAN, the eval forward
with every BatchNorm folded into its FC and E computed once at build,
replayed from CUDA graphs on the card.

Spans (core/tracing.py): gman.forward over gman.encoder (input FC and
the L encoder blocks), gman.transform and gman.decoder (the L decoder
blocks and the output FC), all timed on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_outage_tpu_torch.core import tracing
from multimodal_outage_tpu_torch.core.config import GMANConfig
from multimodal_outage_tpu_torch.core.mesh import DATA_AXIS, active_mesh

EPS = 1e-5
KINDS = ("spatial", "temporal", "transform")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over [..., heads, L, d] (temporal: causal), one
    call of F.scaled_dot_product_attention, counted in attention.calls."""
    attention.calls[kind] += 1
    lead = q.shape[:-3]
    q, k, v = (t.reshape(-1, *t.shape[-3:]) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v, is_causal=kind == "temporal")
    return out.reshape(*lead, *out.shape[-3:])


attention.calls = dict.fromkeys(KINDS, 0)


def _heads(x: torch.Tensor, k: int) -> torch.Tensor:
    """[..., D] → [..., K, d]."""
    return x.unflatten(-1, (k, x.shape[-1] // k))


def spatial_attention(q, k, v, heads: int) -> torch.Tensor:
    """q, k, v [B, N, T, D] → [B, N, T, D]: each (b, t, head) over the N
    counties."""
    qh, kh, vh = (_heads(t, heads).permute(0, 2, 3, 1, 4) for t in (q, k, v))
    return attention(qh, kh, vh, "spatial").permute(0, 3, 1, 2, 4).flatten(-2)


def temporal_attention(q, k, v, heads: int) -> torch.Tensor:
    """q, k, v [B, N, T, D] → [B, N, T, D]: each (b, n, head) over the T
    steps, step i over steps ≤ i."""
    qh, kh, vh = (_heads(t, heads).transpose(2, 3) for t in (q, k, v))
    return attention(qh, kh, vh, "temporal").transpose(2, 3).flatten(-2)


def transform_attention(q, k, v, heads: int) -> torch.Tensor:
    """q [N, Q, D], k [N, P, D] (from E_Q, E_P: the same for every
    sample), v [B, N, P, D] → [B, N, Q, D]: each (b, n, head)'s Q future
    steps over its P past steps."""
    b = v.shape[0]
    qh, kh = (_heads(t, heads).transpose(1, 2).expand(b, -1, -1, -1, -1) for t in (q, k))
    vh = _heads(v, heads).transpose(2, 3)
    return attention(qh, kh, vh, "transform").transpose(2, 3).flatten(-2)


# --- the trainable module ---------------------------------------------------------

Rows = Tuple[Optional[torch.Tensor], object]  # (sample_weight [B] or None, data group)


class BatchNorm(nn.Module):
    """Per-channel BatchNorm over every row of [..., C]: train mode
    normalizes by the biased statistics of the rows (two passes, float32)
    and updates the running statistics by the EMA r ← 0.9·r + 0.1·s of
    the mean and the unbiased variance; eval mode normalizes by the
    running statistics. The output is in the input's dtype.

    rows (batched inputs [B, ...]): the sample weights, whose 0 rows are
    left out of the statistics and the EMA, and the data group over which
    the moments are summed (None: this process's rows are the batch)."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = EPS):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor, train: bool, rows: Optional[Rows] = None) -> torch.Tensor:
        if not train:
            inv = torch.rsqrt(self.var + self.eps) * self.scale
            return ((x.float() - self.mean) * inv + self.bias).to(x.dtype)
        c = x.shape[-1]
        flat = x.float().reshape(-1, c)
        w, group = rows if rows is not None else (None, None)
        if w is None:
            wr = None
            cnt = flat.new_full((1,), float(flat.shape[0]))
        else:
            wr = (torch.as_tensor(w, device=x.device) > 0).float()
            wr = wr.repeat_interleave(flat.shape[0] // x.shape[0])
            cnt = wr.sum().reshape(1)
        s1 = flat.sum(0) if wr is None else wr @ flat
        sums = _sum_over(torch.cat([s1, cnt]), group)
        n = sums[c:]
        mean = sums[:c] / n.clamp(min=1.0)
        d = flat - mean
        sq = d.square()
        var = _sum_over(sq.sum(0) if wr is None else wr @ sq, group) / n.clamp(min=1.0)
        self._update_running(mean.detach(), var.detach(), n.detach())
        inv = torch.rsqrt(var + self.eps) * self.scale
        return (d * inv + self.bias).to(x.dtype).reshape(x.shape)

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor, n: torch.Tensor) -> None:
        """The EMA of the batch's statistics; a batch of no valid row leaves
        them unchanged (no host sync: a where, not a branch)."""
        m = self.momentum
        unbiased = var * n / (n - 1).clamp(min=1.0)
        self.mean.copy_(torch.where(n > 0, (1 - m) * self.mean + m * mean, self.mean))
        self.var.copy_(torch.where(n > 0, (1 - m) * self.var + m * unbiased, self.var))


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    from multimodal_outage_tpu_torch.parallel.collectives import sum_over

    return sum_over(x, group)


class FC(nn.Module):
    """a(BN(x·W + b)) in the compute dtype; kernel [cin, cout]."""

    def __init__(self, cin: int, cout: int, relu: bool, dtype: torch.dtype, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.bn = BatchNorm(cout)
        self.relu, self.dtype = relu, dtype

    def forward(self, x: torch.Tensor, train: bool, rows: Optional[Rows] = None) -> torch.Tensor:
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        y = self.bn(y, train, rows)
        return torch.relu(y) if self.relu else y


class FC2(nn.Module):
    """FC²[u₁, u₂]: FC_relu then FC_none."""

    def __init__(self, cin: int, hidden: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = FC(cin, hidden, True, dtype)
        self.fc2 = FC(hidden, cout, False, dtype)

    def forward(self, x, train: bool, rows: Optional[Rows] = None) -> torch.Tensor:
        return self.fc2(self.fc1(x, train, rows), train, rows)


class SelfAttention(nn.Module):
    """Spatial or temporal attention of an ST block: q, k, v = FC_relu([H ‖
    E]) of width D each, the attention, FC²[D, D]."""

    def __init__(self, kind: str, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.kind, self.heads = kind, heads
        self.query = FC(2 * width, width, True, dtype)
        self.key = FC(2 * width, width, True, dtype)
        self.value = FC(2 * width, width, True, dtype)
        self.out = FC2(width, width, width, dtype)

    def forward(self, x, train: bool, rows: Rows) -> torch.Tensor:
        q, k, v = (fc(x, train, rows) for fc in (self.query, self.key, self.value))
        fn = spatial_attention if self.kind == "spatial" else temporal_attention
        return self.out(fn(q, k, v, self.heads), train, rows)


class GatedFusion(nn.Module):
    """g = σ(FC_none,no bias(HS) + FC_none(HT)); FC²[D, D](g⊙HS + (1 − g)⊙HT)."""

    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.xs = FC(width, width, False, dtype, bias=False)
        self.xt = FC(width, width, False, dtype)
        self.out = FC2(width, width, width, dtype)

    def forward(self, hs, ht, train: bool, rows: Rows) -> torch.Tensor:
        g = torch.sigmoid(self.xs(hs, train, rows) + self.xt(ht, train, rows))
        return self.out(g * hs + (1 - g) * ht, train, rows)


class STBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.spatial = SelfAttention("spatial", width, heads, dtype)
        self.temporal = SelfAttention("temporal", width, heads, dtype)
        self.fusion = GatedFusion(width, dtype)

    def forward(self, h, e, train: bool, rows: Rows) -> torch.Tensor:
        """h [B, N, T, D], e [N, T, D] → H + H_f."""
        x = torch.cat([h, e.to(h.dtype).expand(h.shape[0], -1, -1, -1)], -1)
        hs, ht = self.spatial(x, train, rows), self.temporal(x, train, rows)
        return h + self.fusion(hs, ht, train, rows)


class TransformAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.query = FC(width, width, True, dtype)
        self.key = FC(width, width, True, dtype)
        self.value = FC(width, width, True, dtype)
        self.out = FC2(width, width, width, dtype)

    def forward(self, h, ep, eq, train: bool, rows: Rows) -> torch.Tensor:
        q, k = self.query(eq, train), self.key(ep, train)
        v = self.value(h, train, rows)
        return self.out(transform_attention(q, k, v, self.heads), train, rows)


def _check_steps(cfg: GMANConfig, horizon: int) -> None:
    if cfg.steps != 2 * horizon:
        raise ValueError(f"GMANConfig.steps ({cfg.steps}) must be P + Q = 2·horizon "
                         f"({2 * horizon}): the fusion model's windows are horizon days in "
                         "and horizon days out")


class GMAN(nn.Module):
    """[B, N, P, input_dim] → [B, N, horizon, output_dim] (module docstring),
    P = horizon; TE one-hot encodes cfg.steps = P + Q steps."""

    def __init__(self, input_dim: int, output_dim: int, n_nodes: int, horizon: int,
                 cfg: GMANConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        _check_steps(cfg, horizon)
        w, k = cfg.width, cfg.num_heads
        self.p = self.q = horizon
        self.heads, self.dtype = k, dtype
        self.input = FC2(input_dim, w, w, dtype)
        self.spatial_embedding = nn.Parameter(torch.zeros(n_nodes, w), requires_grad=False)
        self.se = FC2(w, w, w, dtype)
        self.te = FC2(cfg.steps, w, w, dtype)
        self.encoder = nn.ModuleDict({f"block{l}": STBlock(w, k, dtype)
                                      for l in range(cfg.num_blocks)})
        self.transform = TransformAttention(w, k, dtype)
        self.decoder = nn.ModuleDict({f"block{l}": STBlock(w, k, dtype)
                                      for l in range(cfg.num_blocks)})
        self.output = FC2(w, w, output_dim, dtype)

    def embedding(self, train: bool) -> torch.Tensor:
        """E = SE + TE [N, P + Q, D]."""
        s = self.spatial_embedding
        se = self.se(s, train)
        te = self.te(torch.eye(self.p + self.q, device=s.device), train)
        return se[:, None] + te[None]

    def forward(self, x: torch.Tensor, supports: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                sample_weight=None) -> torch.Tensor:
        """`supports` and `generator` are unused: GMAN reads no static
        support and has no dropout."""
        b, n, p, _ = x.shape
        if p != self.p:
            raise ValueError(f"GMAN built for {self.p} input steps, given {p}")
        mesh = active_mesh()
        group = mesh.group(DATA_AXIS) if mesh is not None and mesh.shape.data > 1 else None
        rows = (sample_weight, group)
        card = x.is_cuda
        with tracing.span("gman.forward", device=card):
            e = self.embedding(train)
            ep, eq = e[:, :p], e[:, p:]
            with tracing.span("gman.encoder", device=card):
                h = self.input(x, train, rows)
                for blk in self.encoder.values():
                    h = blk(h, ep, train, rows)
            with tracing.span("gman.transform", device=card):
                h = self.transform(h, ep, eq, train, rows)
            with tracing.span("gman.decoder", device=card):
                for blk in self.decoder.values():
                    h = blk(h, eq, train, rows)
                return self.output(h, train, rows)


# --- the serving engine's eval forward ------------------------------------------

Tree = Dict[str, object]


def _fold(p: Tree, s: Tree, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """An FC's (W′, b′) in float32 with its eval-mode BatchNorm folded in:
    W′ = W·γ/√(σ² + ε), b′ = (b − μ)·γ/√(σ² + ε) + β."""
    f = lambda v: torch.as_tensor(v).to(device, torch.float32)
    inv = f(p["bn"]["scale"]) * torch.rsqrt(f(s["bn"]["var"]) + EPS)
    b = f(p["bias"]) if "bias" in p else 0.0
    return f(p["kernel"]) * inv, (b - f(s["bn"]["mean"])) * inv + f(p["bn"]["bias"])


class FoldedGMAN:
    """GMAN's eval forward from a variables subtree (params/st_gnn,
    batch_stats/st_gnn), every BatchNorm folded into its FC at build and
    the constants of eval mode computed once:

      E (the STE), and with it each block's E part of the spatial and
      temporal q, k, v: X·W = H·W_H + E·W_E, so one GEMM H·[W_H of the
      six] plus a constant [N, T, 6D] term gives all six;
      the transform attention's q and k, from E_Q and E_P alone;
      the gated fusion's two FCs as one GEMM of [HS ‖ HT].

    On the card each of the three stages (the spans' encoder, transform,
    decoder) replays as a CUDA graph, captured at the first call of a
    shape: eagerly a forward issues ~140 small kernels, each costing more
    host time than device time, so the B=1 forecast waited on the host.

    z [B, N, P, F + E] in the compute dtype → [B, N, Q, F]."""

    def __init__(self, st: Tree, st_bs: Tree, cfg: GMANConfig, horizon: int, device,
                 dtype: torch.dtype):
        _check_steps(cfg, horizon)
        self.heads, self.p, self.dtype = cfg.num_heads, horizon, dtype
        w = cfg.width
        cast = lambda t: t.to(dtype).contiguous()

        def fc(p, s):
            kernel, bias = _fold(p, s, device)
            return cast(kernel), cast(bias)

        def fc2(p, s):
            return fc(p["fc1"], s["fc1"]) + fc(p["fc2"], s["fc2"])

        def fc2_f32(p, s, x):
            w1, b1 = _fold(p["fc1"], s["fc1"], device)
            w2, b2 = _fold(p["fc2"], s["fc2"], device)
            return torch.relu(x @ w1 + b1) @ w2 + b2

        s_emb = torch.as_tensor(st["spatial_embedding"]).to(device, torch.float32)
        se = fc2_f32(st["se"], st_bs["se"], s_emb)
        te = fc2_f32(st["te"], st_bs["te"], torch.eye(cfg.steps, device=device))
        e = se[:, None] + te[None]  # [N, P + Q, D], float32
        ep, eq = e[:, :horizon], e[:, horizon:]

        def block(p, s, e_t):
            ws, bs_ = [], []
            for att in ("spatial", "temporal"):
                for name in ("query", "key", "value"):
                    kernel, bias = _fold(p[att][name], s[att][name], device)
                    ws.append(kernel)
                    bs_.append(bias)
            w6 = torch.cat(ws, 1)  # [2D, 6D]: rows H then E
            c6 = e_t.reshape(-1, w) @ w6[w:] + torch.cat(bs_)  # [N·T, 6D]
            (ws_, bs2), (wt_, bt_) = (_fold(p["fusion"][k], s["fusion"][k], device)
                                      for k in ("xs", "xt"))
            return {"w6": cast(w6[:w]), "c6": cast(c6),
                    "spatial": fc2(p["spatial"]["out"], s["spatial"]["out"]),
                    "temporal": fc2(p["temporal"]["out"], s["temporal"]["out"]),
                    "gate": (cast(torch.cat([ws_, wt_])), cast(bs2 + bt_)),
                    "fusion": fc2(p["fusion"]["out"], s["fusion"]["out"])}

        self.input = fc2(st["input"], st_bs["input"])
        blocks = [f"block{l}" for l in range(cfg.num_blocks)]
        self.encoder = [block(st["encoder"][k], st_bs["encoder"][k], ep) for k in blocks]
        tp, ts = st["transform"], st_bs["transform"]
        qk = []
        for name, e_t in (("query", eq), ("key", ep)):
            kernel, bias = _fold(tp[name], ts[name], device)
            qk.append(cast(torch.relu(e_t @ kernel + bias)))
        self.transform_qk = tuple(qk)
        self.transform_v = fc(tp["value"], ts["value"])
        self.transform_out = fc2(tp["out"], ts["out"])
        self.decoder = [block(st["decoder"][k], st_bs["decoder"][k], eq) for k in blocks]
        self.output = fc2(st["output"], st_bs["output"])
        self._graphs: Dict[tuple, List[Callable]] = {}

    @staticmethod
    def _fc2(x, w1, b1, w2, b2):
        return torch.addmm(b2, torch.relu(torch.addmm(b1, x, w1)), w2)

    def _block(self, h, blk, b, n, t):
        """h [B·N·T, D] → h + H_f."""
        w = h.shape[1]
        qkv = torch.relu(torch.baddbmm(blk["c6"].expand(b, -1, -1), h.view(b, n * t, w),
                                       blk["w6"].expand(b, -1, -1)))
        qkv = qkv.view(b, n, t, 6 * w)
        part = lambda i: qkv[..., i * w:(i + 1) * w]
        o_s = spatial_attention(part(0), part(1), part(2), self.heads).reshape(-1, w)
        o_t = temporal_attention(part(3), part(4), part(5), self.heads).reshape(-1, w)
        hs, ht = self._fc2(o_s, *blk["spatial"]), self._fc2(o_t, *blk["temporal"])
        g = torch.sigmoid(torch.addmm(blk["gate"][1], torch.cat([hs, ht], 1), blk["gate"][0]))
        return h + self._fc2(torch.lerp(ht, hs, g), *blk["fusion"])

    def _eager(self, b: int, n: int) -> List[Callable]:
        """The three stages (the spans' encoder, transform, decoder) at
        batch b over n counties: z [B, N, P, F + E] → h [B·N·P, D] → h
        [B·N·Q, D] → [B, N, Q, F]."""

        def encoder(z):
            h = self._fc2(z.reshape(b * n * self.p, -1).to(self.dtype), *self.input)
            for blk in self.encoder:
                h = self._block(h, blk, b, n, self.p)
            return h

        def transform(h):
            w = h.shape[1]
            v = torch.relu(torch.addmm(self.transform_v[1], h, self.transform_v[0]))
            o = transform_attention(*self.transform_qk, v.view(b, n, self.p, w), self.heads)
            return self._fc2(o.reshape(-1, w), *self.transform_out)

        def decoder(h):
            for blk in self.decoder:
                h = self._block(h, blk, b, n, self.p)
            return self._fc2(h, *self.output).view(b, n, self.p, -1)

        return [encoder, transform, decoder]

    def _graphed(self, z: torch.Tensor) -> List[Callable]:
        """The stages at z's shape as CUDA graphs, captured on the first call
        (after one eager pass on a side stream makes the libraries' plans and
        workspaces) into one memory pool: each replays in one call, the
        first after copying z into its captured input. An output is the
        graph's own buffer, overwritten by the next forward of that shape."""
        key = tuple(z.shape)
        if key not in self._graphs:
            stages = self._eager(*z.shape[:2])
            x = z_in = z.detach().clone()
            side = torch.cuda.Stream(z.device)
            side.wait_stream(torch.cuda.current_stream(z.device))
            with torch.cuda.stream(side):
                for stage in stages:
                    x = stage(x)
            torch.cuda.current_stream(z.device).wait_stream(side)
            replays, pool, x = [], None, z_in
            for i, stage in enumerate(stages):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=pool, capture_error_mode="thread_local"):
                    x = stage(x)
                pool = g.pool()
                replays.append(_replay(g, x, z_in if i == 0 else None))
            self._graphs[key] = replays
        return self._graphs[key]

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        b, n, p, _ = z.shape
        if p != self.p:
            raise ValueError(f"GMAN built for {self.p} input steps, given {p}")
        card = z.is_cuda
        stages = self._graphed(z) if card else self._eager(b, n)
        with tracing.span("gman.forward", device=card):
            x = z
            for name, stage in zip(("gman.encoder", "gman.transform", "gman.decoder"), stages):
                with tracing.span(name, device=card):
                    x = stage(x)
            return x


def _replay(graph: torch.cuda.CUDAGraph, out: torch.Tensor,
            into: Optional[torch.Tensor]) -> Callable:
    """A captured stage: copy its input in (the first stage), replay, return
    the graph's output buffer."""

    def run(x: torch.Tensor) -> torch.Tensor:
        if into is not None:
            into.copy_(x)
        graph.replay()
        return out

    return run
