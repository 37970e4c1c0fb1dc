"""Weight bridge: the JAX package's variable tree ⇄ the port's tensors.

The port keeps the flax tree as it is — {"params", "batch_stats"} nested
by module name, with the same key paths — and the flax layouts: Dense
kernels [in, out] (used as x @ W), conv kernels HWIO (the NHWC DoubleConv
kernel reads them as they are). Only the ConvTranspose kernel changes
layout, where it is handed to F.conv_transpose2d (conv_transpose_weight).
The trainable model's parameters and buffers sit under the same paths
(module_variables / load_variables), so a trained module feeds the
serving engine or a checkpoint as it is. Loading orbax checkpoints is a
ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from multimodal_outage_tpu_torch.core.config import ModelConfig
from multimodal_outage_tpu_torch.data.adjacency import model_adjtype, n_static_supports

# Typical magnitudes of the raw [0,0,0,y,m,d] Date2Vec inputs; its encoder
# kernels are scaled inversely so random-init embeddings are O(1)
# (JAX models/date2vec.py:28).
_D2V_FEATURE_SCALE = np.asarray((1.0, 1.0, 1.0, 2000.0, 6.5, 15.5), np.float32)

Tree = Dict[str, Any]


def from_flax(variables: Tree) -> Tree:
    """Nested dicts of numpy (or JAX) arrays → the same tree of float32
    CPU tensors."""
    if hasattr(variables, "items"):
        return {k: from_flax(v) for k, v in variables.items()}
    return torch.from_numpy(np.array(variables, dtype=np.float32))


def conv_transpose_weight(kernel: torch.Tensor) -> torch.Tensor:
    """flax ConvTranspose kernel [kh, kw, in, out] → F.conv_transpose2d
    weight [in, out, kh, kw]. flax's transposed conv is a correlation over
    the dilated input, torch's the gradient of a convolution: the same op
    only with the kernel flipped in both spatial axes
    (JAX parity/torch_import.py:55-69)."""
    return kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()


def flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Tree:
    tree: Tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def module_variables(module: torch.nn.Module) -> Tree:
    """A module's {"params", "batch_stats"} tree: parameters and buffers
    under their flax key paths (module attribute names joined by "/").
    The leaves are the module's own tensors, detached, not copies; the
    tree feeds ServingModel or a checkpoint as it is."""
    return {
        "params": unflatten(
            {k.replace(".", "/"): v.detach() for k, v in module.named_parameters()}
        ),
        "batch_stats": unflatten(
            {k.replace(".", "/"): v.detach() for k, v in module.named_buffers()}
        ),
    }


def load_variables(module: torch.nn.Module, variables: Tree) -> torch.nn.Module:
    """Copy a {"params", "batch_stats"} tree (flax key paths, any array
    type) into a module's parameters and buffers, on their device and in
    their dtype. Every leaf must match one tensor of the module by path
    and shape, and every tensor must be given."""
    want = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    want = {k.replace(".", "/"): v for k, v in want.items()}
    given = {
        **flatten(variables.get("params", {})), **flatten(variables.get("batch_stats", {})),
    }
    missing, extra = sorted(set(want) - set(given)), sorted(set(given) - set(want))
    if missing or extra:
        raise ValueError(f"variable tree does not match the module: missing {missing}, extra {extra}")
    with torch.no_grad():
        for path, dst in want.items():
            src = given[path]
            src = src if torch.is_tensor(src) else torch.from_numpy(np.array(src, np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{path}: shape {tuple(src.shape)} given, {tuple(dst.shape)} wanted")
            dst.copy_(src.to(dst.device, dst.dtype))
    return module


def save_npz(path: str, variables: Tree) -> None:
    """Write the tree as an .npz of flattened a/b/c paths."""
    np.savez(
        path,
        **{k: np.asarray(torch.as_tensor(v).float().cpu()) for k, v in flatten(variables).items()},
    )


def load_npz(path: str) -> Tree:
    with np.load(path) as f:
        return unflatten({k: torch.from_numpy(f[k].copy()) for k in f.files})


def _lecun(rng: np.random.Generator, shape, fan_in: int) -> np.ndarray:
    """flax lecun_normal: truncated (±2σ) normal, variance 1/fan_in."""
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2
    # 0.8796… is the std of a unit normal truncated at ±2
    return (z * np.sqrt(1.0 / fan_in) / 0.87962566103423978).astype(np.float32)


def _dcrnn_params(cfg: ModelConfig, n_supports: int, dense) -> Tree:
    """The DCRNN tree (JAX models/dcrnn.py under nn.scan): encoder and
    decoder cells, each with gates (bias 1.0) and candidate diffusion
    convolutions, and the decoder's output proj."""
    d, fvs = cfg.dcrnn, cfg.feature_vector_size
    u, nt = d.rnn_units, 1 + n_supports * d.max_diffusion_step

    def cell(dx: int) -> Tree:
        gates, cand = dense(nt * (dx + u), 2 * u), dense(nt * (dx + u), u)
        gates["bias"] = np.ones(2 * u, np.float32)
        return {"gates": {"proj": gates}, "candidate": {"proj": cand}}

    def cells(d0: int) -> Tree:
        return {f"cell{l}": cell(d0 if l == 0 else u) for l in range(d.num_rnn_layers)}

    return {"encoder": cells(cfg.st_gnn_in_dim),
            "decoder": {**cells(fvs), "proj": dense(u, fvs)}}


def _gwnet_params(cfg: ModelConfig, n_nodes: int, n_static: int, rng, dense, bn):
    """The Graph WaveNet (params, batch_stats) trees (JAX models/gwnet.py):
    flat filter_conv{i}_kernel, … on the fused path (kernel_size 1 and a
    support); on the others nested filter_conv{i}/gate_conv{i} convs
    (kernel [k, C, Cd]), skip_conv{i}, and gconv{i}/mlp over the supports
    or residual_conv{i} without any. Without gcn_bool the static supports
    are dropped and there are no node embeddings."""
    g = cfg.gwnet
    c, cd, cs, ce = g.residual_channels, g.dilation_channels, g.skip_channels, g.end_channels
    adaptive = g.addaptadj and g.gcn_bool
    n_sup = (n_static if g.gcn_bool else 0) + int(adaptive)
    nt = n_sup * g.order + 1
    k = g.kernel_size
    st: Tree = {"start_conv": dense(cfg.st_gnn_in_dim, c)}
    st_stats: Tree = {}
    if adaptive:
        st["nodevec1"] = rng.standard_normal((n_nodes, g.node_embed_dim)).astype(np.float32)
        st["nodevec2"] = rng.standard_normal((g.node_embed_dim, n_nodes)).astype(np.float32)
    for i in range(g.blocks * g.layers):
        if k == 1 and n_sup:
            for name, (cin_, cout_) in (
                ("filter_conv", (c, cd)), ("gate_conv", (c, cd)),
                ("skip_conv", (cd, cs)), ("gconv", (nt * cd, c)),
            ):
                d = dense(cin_, cout_)
                st[f"{name}{i}_kernel"], st[f"{name}{i}_bias"] = d["kernel"], d["bias"]
        else:
            for name in ("filter_conv", "gate_conv"):
                st[f"{name}{i}"] = {"kernel": _lecun(rng, (k, c, cd), k * c),
                                    "bias": np.zeros(cd, np.float32)}
            st[f"skip_conv{i}"] = dense(cd, cs)
            if n_sup:
                st[f"gconv{i}"] = {"mlp": dense(nt * cd, c)}
            else:
                st[f"residual_conv{i}"] = dense(cd, c)
        st[f"bn{i}"], st_stats[f"bn{i}"] = bn(c)
    st["end_conv_1"] = dense(cs, ce)
    st["end_conv_2"] = dense(ce, cfg.feature_vector_size)
    return st, st_stats


def init_date2vec(k: int, seed: int) -> Tree:
    """Random params of models/date2vec.py Date2VecAutoencoder (fc1..fc5)
    as float32 numpy arrays, drawn with numpy from `seed` after flax's
    initializers as the JAX Date2Vec uses them: lecun_normal kernels
    (fc1, fc2 scaled inversely by the raw feature magnitudes), zero
    biases. The values are not flax's."""
    rng = np.random.default_rng(seed)
    widths = {"fc1": (6, k // 2), "fc2": (6, k // 2 + k % 2), "fc3": (k, k // 2),
              "fc4": (k // 2, 6), "fc5": (6, 6)}
    params: Tree = {}
    for name, (cin, cout) in widths.items():
        kernel = _lecun(rng, (cin, cout), cin)
        if name in ("fc1", "fc2"):
            kernel = kernel / _D2V_FEATURE_SCALE[:, None]
        params[name] = {"kernel": kernel, "bias": np.zeros(cout, np.float32)}
    return params


def date2vec_autoencoder(params: Tree) -> torch.nn.Module:
    """The pretraining module holding a Date2Vec autoencoder's params:
    fc1..fc5 as the JAX package's flax tree holds them (numpy or JAX
    arrays, Dense kernels [in, out]) or as init_date2vec draws them. Its
    width k is read off fc1 and fc2; every path must match
    (load_variables)."""
    # models/ imports this module (layers.py: conv_transpose_weight)
    from multimodal_outage_tpu_torch.models.date2vec import Date2VecAutoencoder

    k = np.shape(params["fc1"]["kernel"])[1] + np.shape(params["fc2"]["kernel"])[1]
    return load_variables(Date2VecAutoencoder(k), {"params": params})


def init_variables(
    cfg: ModelConfig, horizon: int, n_counties: int, seed: int,
    image_size: int = 128,
) -> Tree:
    """Random variables with exactly the key paths and shapes of the JAX
    package's build_model(cfg, horizon).init(...) on [B, n_counties, T,
    image_size, image_size, C] inputs with the static supports of the
    st-GNN's adjtype (data/adjacency.py model_adjtype), as float32
    tensors, made with numpy from `seed`. Distributions follow flax's
    initializers (lecun_normal kernels, zero biases, unit BN scales, N(0, 1)
    node embeddings, DCRNN gate biases 1.0); the values are not flax's.
    horizon changes no shape of either st-GNN. Every GWNetConfig branch
    is covered (_gwnet_params); the node embeddings are random, also where
    fit installs svd_aptinit's after."""
    del horizon
    if cfg.st_gnn not in ("gwnet", "dcrnn"):
        raise ValueError(f"unknown st_gnn {cfg.st_gnn!r}; pick 'gwnet' or 'dcrnn'")
    rng = np.random.default_rng(seed)
    params: Tree = {}
    stats: Tree = {}

    def dense(cin, cout, scale=None):
        k = _lecun(rng, (cin, cout), cin)
        if scale is not None:
            k = k / scale[:, None]
        return {"kernel": k, "bias": np.zeros(cout, np.float32)}

    def bn(c):
        return (
            {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32)},
            {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)},
        )

    def double_conv(cin, c):
        p = {
            "conv1": {"kernel": _lecun(rng, (3, 3, cin, c), 9 * cin)},
            "conv2": {"kernel": _lecun(rng, (3, 3, c, c), 9 * c)},
        }
        s = {}
        for name in ("bn1", "bn2"):
            p[name], s[name] = bn(c)
        return p, s

    depth, base = cfg.depth, cfg.base_channels
    params["contraction"], stats["contraction"] = {}, {}
    pc, sc = params["contraction"], stats["contraction"]
    pc["inc"], sc["inc"] = double_conv(cfg.input_channels, base)
    ch = base
    for i in range(1, depth + 1):
        p, s = double_conv(ch, 2 * ch)
        pc[f"down{i}"], sc[f"down{i}"] = {"conv": p}, {"conv": s}
        ch *= 2

    grid = image_size // (2**depth)
    flat = grid * grid * ch
    hidden = flat // cfg.compression_factor
    fvs = cfg.feature_vector_size
    params["encoder"] = {"fc1": dense(flat, hidden), "fc2": dense(hidden, fvs)}
    k = cfg.time_embed_size
    params["date2vec"] = {
        "fc1": dense(6, k // 2, _D2V_FEATURE_SCALE),
        "fc2": dense(6, k // 2 + k % 2, _D2V_FEATURE_SCALE),
    }

    n_static = n_static_supports(model_adjtype(cfg))
    if cfg.st_gnn == "dcrnn":
        # no BatchNorm, so no batch_stats entry
        params["st_gnn"] = _dcrnn_params(cfg, n_static, dense)
    else:
        params["st_gnn"], stats["st_gnn"] = _gwnet_params(cfg, n_counties, n_static, rng, dense, bn)

    params["decoder"] = {
        "fc1": dense(fvs, fvs * cfg.compression_factor),
        "fc2": dense(fvs * cfg.compression_factor, flat),
    }

    params["expansion"], stats["expansion"] = {}, {}
    pe, se = params["expansion"], stats["expansion"]
    skip_ch = base * 2 ** (depth - 1)
    for i in range(1, depth + 1):
        up = {
            "kernel": _lecun(rng, (2, 2, ch, ch // 2), 4 * ch),
            "bias": np.zeros(ch // 2, np.float32),
        }
        p, s = double_conv(skip_ch + ch // 2, skip_ch)
        pe[f"up{i}"], se[f"up{i}"] = {"up": up, "conv": p}, {"conv": s}
        ch, skip_ch = skip_ch, skip_ch // 2
    pe["outc"] = {
        "conv": {
            "kernel": _lecun(rng, (1, 1, ch, cfg.output_channels), ch),
            "bias": np.zeros(cfg.output_channels, np.float32),
        }
    }
    return from_flax({"params": params, "batch_stats": stats})
