"""The port's per-layer Graph WaveNet op (ops/gwnet_layer.py) and the
use_pallas Graph WaveNet module on the CPU, against the JAX package's
fused_gwnet_layer (its Pallas kernel in interpret mode, its custom_vjp
backward) and flax GraphWaveNet(use_pallas=True, pallas_interpret=True):
the same numpy inputs and weights, float32, at the JAX tests' own small
shapes (tests/test_pallas_ops.py).

Bars: forwards atol 5e-5 / rtol 1e-4 (summation order only); each
gradient leaf within 1e-4 of its largest entry + 1e-7; module parameter
gradients also + 1e-6 of the module's largest gradient, for leaves whose
true gradient is 0 (tests/test_torch_port_layers.py says why); running
statistics atol 1e-6 / rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.models.gwnet import GraphWaveNet as JaxGraphWaveNet
from multimodal_outage_tpu.ops.gwnet_pallas import fused_gwnet_layer as jax_fused_gwnet_layer
from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
from multimodal_outage_tpu_torch.models.gwnet import GraphWaveNet
from multimodal_outage_tpu_torch.ops import gwnet_layer as glm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, N, T, C, CD, CS = 2, 7, 3, 8, 8, 16
ORDER = 2
TOL = dict(atol=5e-5, rtol=1e-4)


def _inputs(s_count, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((s_count, N, N))
    sup = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    nt = s_count * ORDER + 1
    shapes = [(C, CD), (CD,), (C, CD), (CD,), (CD, CS), (CS,), (nt * CD, C), (C,)]
    params = [rng.standard_normal(s) * (0.3 if len(s) == 2 else 0.1) for s in shapes]
    x = rng.standard_normal((B, N, T, C))
    return [a.astype(np.float32) for a in (x, sup, *params)]


@pytest.mark.parametrize("s_count", [1, 2, 3])
def test_forward_matches_jax_kernel_interpret(s_count):
    args = _inputs(s_count)
    hj, sj = jax_fused_gwnet_layer(*(jnp.asarray(a) for a in args), ORDER, True)
    targs = [torch.from_numpy(a) for a in args]
    before = glm.gwnet_layer_forward.launches
    for fn in (glm.gwnet_layer_reference, glm.gwnet_layer_forward, glm.fused_gwnet_layer):
        h, s = fn(*targs, order=ORDER)
        assert tuple(h.shape) == (B, N, T, C) and tuple(s.shape) == (B, N, T, CS)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(s.detach().numpy(), np.asarray(sj), **TOL)
    assert glm.gwnet_layer_forward.launches == before  # the CPU runs no kernel


@pytest.mark.parametrize("s_count", [1, 2])
def test_gradients_match_jax_custom_vjp(s_count):
    """Every input's gradient, supports included (the adaptive adjacency
    learns through it), against jax.vjp of the JAX fused_gwnet_layer."""
    args = _inputs(s_count, seed=1)
    rng = np.random.default_rng(2)
    dh = rng.standard_normal((B, N, T, C)).astype(np.float32)
    ds = rng.standard_normal((B, N, T, CS)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_fused_gwnet_layer(*a, ORDER, True),
                     *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dh), jnp.asarray(ds)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    h, s = glm.fused_gwnet_layer(*leaves, order=ORDER)
    torch.autograd.backward((h, s), (torch.from_numpy(dh), torch.from_numpy(ds)))
    assert len(want) == len(leaves) == 10
    for name, leaf, w in zip(("x", "supports", "wf", "bf", "wg", "bg", "ws", "bs", "wc", "bc"),
                             leaves, want):
        w = np.asarray(w)
        assert np.abs(leaf.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, name
    assert np.abs(leaves[1].grad.numpy()).max() > 0


OUT, D_IN = 12, 16
SMALL = dict(residual_channels=8, dilation_channels=8, skip_channels=16, end_channels=16,
             blocks=2, layers=2, node_embed_dim=4)


def _module_case(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, T, D_IN)).astype(np.float32)
    cot = rng.standard_normal((B, N, T, OUT)).astype(np.float32)
    sup = np.eye(N, dtype=np.float32)[None]
    jmod = JaxGraphWaveNet(out_dim=OUT, dropout=0.0, bn_single_pass=True, use_pallas=True,
                           pallas_interpret=True, **SMALL)
    var = jmod.init(jax.random.PRNGKey(seed), x, sup, False)
    bs = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        var["batch_stats"],
    )
    var = {"params": var["params"], "batch_stats": bs}
    cfg = ModelConfig(compute_dtype="float32", feature_vector_size=OUT, time_embed_size=D_IN - OUT,
                      gwnet=GWNetConfig(dropout=0.0, use_pallas=True, **SMALL))
    tmod = weights.load_variables(GraphWaveNet(cfg, N, 1),
                                  weights.from_flax(jax.tree.map(np.asarray, var)))
    return jmod, tmod, var, x, cot, sup


def test_module_eval_matches_flax():
    jmod, tmod, var, x, _, sup = _module_case()
    want = np.asarray(jmod.apply(var, x, sup, False))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(sup), False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_module_train_matches_flax():
    """Train mode, dropout 0: output, BN running stats, and the gradients
    of a fixed cotangent for x and every parameter (nodevec1/2 through
    the supports gradient)."""
    jmod, tmod, var, x, cot, sup = _module_case()

    def f(params, xx):
        y, mut = jmod.apply({"params": params, "batch_stats": var["batch_stats"]}, xx, sup,
                            True, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    (yj, bsj), vjp = jax.vjp(f, var["params"], jnp.asarray(x))
    gpj, gxj = vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, bsj)))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tmod(xt, torch.from_numpy(sup), True)
    yt.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), **TOL)
    fs = weights.flatten(jax.tree.map(np.asarray, bsj))
    ts = weights.flatten(weights.module_variables(tmod)["batch_stats"])
    assert set(fs) == set(ts)
    for k in fs:
        np.testing.assert_allclose(ts[k].numpy(), fs[k], atol=1e-6, rtol=1e-5, err_msg=k)
    fg = weights.flatten(jax.tree.map(np.asarray, gpj))
    g_all = max(np.abs(v).max() for v in fg.values())
    for name, p in tmod.named_parameters():
        k = name.replace(".", "/")
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        assert np.abs(got - fg[k]).max() <= 1e-4 * np.abs(fg[k]).max() + 1e-6 * g_all, k
    assert np.abs(tmod.nodevec1.grad.numpy()).max() > 0
