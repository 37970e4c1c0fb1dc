"""DCRNN: an encoder-decoder of diffusion-convolutional GRU cells. A
diffusion convolution projects [x, T_1(A)x, T_2(A)x, ...] per support, with
T_1 = A x and T_k = 2 A T_{k-1} - T_{k-2}; a cell is
r, u = sigmoid(dconv([x, h])), c = tanh(dconv([x, r h])),
h' = u h + (1 - u) c. The encoder runs the stacked cells over T; the
decoder starts from a zero GO symbol and feeds each step its own projected
output, or, in a train step with scheduled sampling, the target latent
where the step's coin came up heads (Li et al., ICLR 2018).

An st-GNN family of the plain reference (reference/model.py says what a
family file exposes).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from outage_bench.reference import model as ref

# the program's filter types and the static supports each reads
SUPPORTS = {"dual_random_walk": "doubletransition", "random_walk": "transition",
            "identity": "identity"}


# the training knobs a traffic mix may set (scheduled sampling)
MIX_KEYS = ("dcrnn.teacher_forcing", "dcrnn.tf_decay_steps")


def support_kind(model: Dict) -> str:
    return SUPPORTS[model["dcrnn"]["filter_type"]]


def teacher(model: Dict) -> Optional[Tuple[float, int]]:
    d = model["dcrnn"]
    return (d["teacher_forcing"], d["tf_decay_steps"]) if d["teacher_forcing"] > 0 else None


def dropout_sites(model: Dict, b: int, n: int, t: int) -> List[Tuple[tuple, float]]:
    """None: DCRNN has no dropout."""
    return []


def layout(model: Dict, n: int, n_static: int) -> List[Tuple[str, tuple, str]]:
    d = model["dcrnn"]
    fvs = model["feature_vector_size"]
    u, nt = d["rnn_units"], 1 + n_static * d["max_diffusion_step"]
    out = []
    for part, d0 in (("encoder", fvs + model["time_embed_size"]), ("decoder", fvs)):
        for l in range(d["num_rnn_layers"]):
            dx = d0 if l == 0 else u
            out += ref.dense_leaves(f"st_gnn/{part}/cell{l}/gates/proj", nt * (dx + u), 2 * u)
            out[-1] = (out[-1][0], out[-1][1], "one")  # gate bias 1.0
            out += ref.dense_leaves(f"st_gnn/{part}/cell{l}/candidate/proj", nt * (dx + u), u)
    out += ref.dense_leaves("st_gnn/decoder/proj", u, fvs)
    return out


def forward(z, st, sbs, supports, cfg, train: bool, drop, q: ref.Quant,
            teacher: Optional[Dict] = None):
    d = cfg["dcrnn"]
    k, units, layers = d["max_diffusion_step"], d["rnn_units"], d["num_rnn_layers"]

    def dconv(x, p):
        terms = [x]
        for a in supports:
            x0, x1 = x, ref.diffuse(x, a, q)
            terms.append(x1)
            for _ in range(2, k + 1):
                x0, x1 = x1, 2.0 * ref.diffuse(x1, a, q) - x0
                terms.append(x1)
        return ref.dense(torch.cat(terms, -1), p["proj"], q)

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
    for ti in range(t):
        inp = prev
        for l in range(layers):
            h[l] = inp = cell(st["decoder"][f"cell{l}"], h[l], inp)
        prev = ref.dense(inp, st["decoder"]["proj"], q)
        outs.append(prev)
        if teacher is not None and teacher["heads"][ti]:
            prev = teacher["latent"][:, :, ti]
    return torch.stack(outs, dim=2)
