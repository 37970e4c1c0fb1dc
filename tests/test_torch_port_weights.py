"""The port's weight bridge against the JAX package's flax trees."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_outage_tpu.core.config import small_test_config
from multimodal_outage_tpu.models.fusion import build_model
from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig


def _flax_shapes(cfg, n, image_size, n_static):
    b, t = 1, 2
    x = jnp.zeros((b, n, t, image_size, image_size, 1))
    feats = jnp.zeros((b, t, 6))
    sup = jnp.stack([jnp.eye(n)] * n_static)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(
        lambda: build_model(cfg, 2).init(
            {"params": key, "dropout": key}, x, feats, sup, train=False
        )
    )
    return {
        "/".join(str(k.key) for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.mark.parametrize(
    "adjtype,addaptadj", [("identity", True), ("doubletransition", False)]
)
def test_init_variables_matches_flax_tree(adjtype, addaptadj):
    jcfg = small_test_config().model
    jcfg = dataclasses.replace(
        jcfg, gwnet=dataclasses.replace(jcfg.gwnet, adjtype=adjtype, addaptadj=addaptadj)
    )
    want = _flax_shapes(jcfg, 4, 16, 2 if adjtype == "doubletransition" else 1)
    cfg = ModelConfig(
        compute_dtype="float32", gwnet=GWNetConfig(adjtype=adjtype, addaptadj=addaptadj)
    )
    got = {
        k: tuple(v.shape)
        for k, v in weights.flatten(weights.init_variables(cfg, 2, 4, seed=0, image_size=16)).items()
    }
    assert got == want


def test_init_variables_is_seeded():
    cfg = ModelConfig(compute_dtype="float32")
    a = weights.flatten(weights.init_variables(cfg, 2, 4, seed=3, image_size=16))
    b = weights.flatten(weights.init_variables(cfg, 2, 4, seed=3, image_size=16))
    c = weights.flatten(weights.init_variables(cfg, 2, 4, seed=4, image_size=16))
    k = "params/contraction/inc/conv1/kernel"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    assert all(v.dtype == torch.float32 for v in a.values())


def test_from_flax_and_npz_round_trip(tmp_path):
    cfg = small_test_config().model
    x = jnp.zeros((1, 4, 2, 16, 16, 1))
    key = jax.random.PRNGKey(1)
    variables = build_model(cfg, 2).init(
        {"params": key, "dropout": key}, x, jnp.zeros((1, 2, 6)), jnp.eye(4)[None],
        train=False,
    )
    tree = weights.from_flax(jax.tree.map(np.asarray, variables))
    flat_j = {
        "/".join(str(k.key) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]
    }
    flat_t = weights.flatten(tree)
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[k].numpy(), v)
    path = str(tmp_path / "w.npz")
    weights.save_npz(path, tree)
    back = weights.flatten(weights.load_npz(path))
    assert back.keys() == flat_t.keys()
    for k, v in flat_t.items():
        assert torch.equal(back[k], v)


def test_conv_transpose_flip_matches_jax():
    """flax's ConvTranspose (lax.conv_transpose, HWIO, no kernel
    transpose) equals F.conv_transpose2d only with the spatial flip."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 5, 6)).astype(np.float32)  # NHWC
    k = rng.standard_normal((2, 2, 6, 3)).astype(np.float32)  # HWIO
    want = jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(k), strides=(2, 2), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    w = weights.conv_transpose_weight(torch.from_numpy(k))
    got = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, stride=2)
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-5
    )
    unflipped = F.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(k).permute(2, 3, 0, 1), stride=2,
    )
    assert not np.allclose(unflipped.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-3)


def test_init_variables_rejects_unported_configs():
    """gcn_bool=False and kernel_size=2, which init_variables refused before
    the non-fused Graph WaveNet branches were ported, now give the trees
    build_model's modules load (residual_conv{i}, no node embeddings;
    filter_conv{i}/kernel [2, C, Cd]) and a finite forward. The JAX
    package's trees: tests/test_torch_port_gwnet_branches.py."""
    from multimodal_outage_tpu_torch.models.fusion import build_model as port_build_model

    for gw in (GWNetConfig(gcn_bool=False), GWNetConfig(kernel_size=2)):
        cfg = ModelConfig(compute_dtype="float32", gwnet=gw)
        var = weights.init_variables(cfg, 2, 4, seed=0, image_size=16)
        st = var["params"]["st_gnn"]
        assert ("residual_conv0" in st) == (not gw.gcn_bool)
        assert ("nodevec1" in st) == gw.gcn_bool
        assert tuple(st["filter_conv0"]["kernel"].shape) == (gw.kernel_size, 32, 32)
        model = weights.load_variables(port_build_model(cfg, 2, 4, 16), var)
        with torch.no_grad():
            y = model(torch.ones(1, 4, 2, 16, 16, 1), torch.zeros(1, 2, 6), torch.eye(4)[None])
        assert torch.isfinite(y).all()
