"""The port's two kernel modules against the JAX package's TPU kernels.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the Pallas kernels in interpret mode and against the JAX plain
references, with inputs made by numpy from a seed. The kernel-vs-plain
tests need the card and live in test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.models.gwnet import GraphWaveNet
from multimodal_outage_tpu.ops import gwnet_stack_pallas as jstack
from multimodal_outage_tpu.ops import unet_pallas as junet
from multimodal_outage_tpu_torch.ops import double_conv as dcm
from multimodal_outage_tpu_torch.weights import from_flax
from multimodal_outage_tpu_torch.ops import gwnet_stack as gsm


def _double_conv_inputs(m, h, cin, c, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        rng.standard_normal((m, h, h, cin)).astype(f),
        (rng.standard_normal((3, 3, cin, c)) * 0.2).astype(f),
        rng.uniform(0.5, 1.5, c).astype(f),
        (rng.standard_normal(c) * 0.1).astype(f),
        (rng.standard_normal((3, 3, c, c)) * 0.2).astype(f),
        rng.uniform(0.5, 1.5, c).astype(f),
        (rng.standard_normal(c) * 0.1).astype(f),
    )


# Cin=1 (the U-Net stem) and Cin=2C (an expansion block's concat input)
@pytest.mark.parametrize("m,h,cin,c", [(3, 16, 1, 4), (2, 8, 16, 8)])
def test_double_conv_reference_matches_jax(m, h, cin, c):
    args = _double_conv_inputs(m, h, cin, c, seed=cin)
    want_pallas = junet.fused_double_conv(*map(jnp.asarray, args), True)
    want_ref = junet.forward_reference(*map(jnp.asarray, args))
    got = dcm.double_conv_reference(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=2e-5)


def test_double_conv_wrapper_on_cpu_runs_plain_version():
    args = tuple(map(torch.from_numpy, _double_conv_inputs(2, 8, 4, 8, seed=0)))
    before = dcm.fused_double_conv.launches
    out = dcm.fused_double_conv(*args)
    assert dcm.fused_double_conv.launches == before  # no kernel launched
    torch.testing.assert_close(out, dcm.double_conv_reference(*args), rtol=0, atol=0)


def test_double_conv_reference_rounds_intermediate_like_tpu_kernel():
    """In bf16 the intermediate is rounded after the first ReLU
    (unet_pallas.py:70): the port's plain version agrees with the JAX
    plain reference to bf16 resolution."""
    args = _double_conv_inputs(2, 8, 4, 8, seed=5)
    x = jnp.asarray(args[0]).astype(jnp.bfloat16)
    want = junet.forward_reference(x, *map(jnp.asarray, args[1:]))
    xt = torch.from_numpy(args[0]).to(torch.bfloat16)
    w1, s1, b1, w2, s2, b2 = map(torch.from_numpy, args[1:])
    got = dcm.double_conv_reference(
        xt, w1.to(torch.bfloat16), s1, b1, w2.to(torch.bfloat16), s2, b2
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=2e-2, atol=2e-2,
    )


@pytest.mark.parametrize("h,cin,c", [(128, 1, 4), (8, 32, 64), (16, 64, 32)])
def test_pick_tile_fits_shared_memory(h, cin, c):
    th, tw, smem = dcm.pick_tile(h, h, cin, c)
    assert th <= h and tw <= h and smem <= 227 * 1024


N, T, CIN = 7, 5, 24


def _gwnet_module_and_variables(addaptadj, b=2):
    """The set-up of tests/test_gwnet_stack.py, inputs made by numpy."""
    m = GraphWaveNet(
        out_dim=20, residual_channels=8, dilation_channels=8,
        skip_channels=16, end_channels=32, blocks=2, layers=2, dropout=0.0,
        order=2, addaptadj=addaptadj, node_embed_dim=4, dtype=jnp.float32,
    )
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, N, T, CIN)).astype(np.float32)
    logits = rng.standard_normal((1, N, N))
    sup = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    variables = m.init({"params": key, "dropout": key}, x, sup, train=False)
    bs = jax.tree.map(
        lambda v: np.asarray(rng.normal(0.1, 0.3, v.shape) ** 2 + 0.5, np.float32),
        variables["batch_stats"],
    )
    return m, {"params": variables["params"], "batch_stats": bs}, x, sup


@pytest.mark.parametrize("addaptadj", [True, False])
def test_stack_reference_matches_jax_kernel(addaptadj):
    m, variables, x, sup = _gwnet_module_and_variables(addaptadj)
    n_layers = m.blocks * m.layers
    p = variables["params"]
    jsp = jstack.stack_params_from_module(p, variables["batch_stats"], n_layers)
    jsup = jstack.adaptive_supports(
        jnp.asarray(sup), p.get("nodevec1"), p.get("nodevec2")
    )
    want = jstack.gwnet_stack_forward(
        jnp.asarray(x), jsup, jsp, order=m.order, interpret=True
    )
    y_module = m.apply(variables, x, sup, train=False)

    tp, tbs = from_flax(p), from_flax(variables["batch_stats"])
    sp = gsm.stack_params_from_module(tp, tbs, n_layers)
    tsup = gsm.adaptive_supports(
        torch.from_numpy(sup), tp.get("nodevec1"), tp.get("nodevec2")
    )
    np.testing.assert_allclose(tsup.numpy(), np.asarray(jsup), atol=1e-7)
    got = gsm.gwnet_stack_forward(torch.from_numpy(x), tsup, sp, order=m.order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_module), atol=3e-5, rtol=1e-4)


def test_stack_params_layout():
    m, variables, _, _ = _gwnet_module_and_variables(True)
    sp = gsm.stack_params_from_module(
        from_flax(variables["params"]), from_flax(variables["batch_stats"]),
        m.blocks * m.layers, dtype=torch.bfloat16,
    )
    assert sp["wfg"].shape == (4, 8, 16) and sp["wc"].shape == (4, 5 * 8, 8)
    assert sp["bc"].dtype == sp["aa"].dtype == sp["ab"].dtype == torch.float32
    assert sp["wfg"].dtype == sp["e2w"].dtype == torch.bfloat16
