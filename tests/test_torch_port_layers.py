"""The port's trainable blocks (models/layers.py, models/gwnet.py) against
the JAX package's flax modules in train mode, float32, on shared numpy
inputs and the same variables: the output, the updated running
statistics, and the gradients of a fixed random cotangent with respect to
the input and to every parameter.

Tolerances: outputs and input gradients atol 1e-5 / rtol 1e-4 (float32,
summation order only); running statistics atol 1e-6 / rtol 1e-5;
parameter gradients within 1e-4 of each leaf's largest entry plus 1e-6
of the module's largest gradient. The second term is for leaves whose
true gradient is 0, where both sides return float32 summation noise: a
bias that feeds straight into a BatchNorm (the Graph WaveNet's gconv
biases) is removed by the normalization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.models import layers as jl
from multimodal_outage_tpu.models.gwnet import GraphWaveNet as JaxGraphWaveNet
from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
from multimodal_outage_tpu_torch.models import layers as tl
from multimodal_outage_tpu_torch.models.gwnet import GraphWaveNet


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed_stats(variables):
    """Non-trivial running statistics so the single-pass shift is used."""
    return {
        "params": variables["params"],
        "batch_stats": jax.tree.map(
            lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
            variables["batch_stats"],
        ),
    }


def _compare(jmod, tmod, variables, inputs, cot, extra=(), t_extra=()):
    """Run flax train mode (value, VJP and mutated batch_stats) and the
    port's module on the same numbers; assert they agree."""

    def f(params, *xs):
        y, mut = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *xs, *extra, True, mutable=["batch_stats"],
        )
        return y, mut["batch_stats"]

    (yj, bsj), vjp = jax.vjp(f, variables["params"], *(jnp.asarray(x) for x in inputs))
    grads = vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, bsj)))
    gpj, gxj = grads[0], grads[1:]

    weights.load_variables(tmod, weights.from_flax(_np_tree(variables)))
    xt = [torch.from_numpy(x).requires_grad_() for x in inputs]
    yt = tmod(*xt, *t_extra, True)
    yt.backward(torch.from_numpy(cot))

    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=1e-5, rtol=1e-4)
    for a, b in zip(xt, gxj):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-5, rtol=1e-4)
    tv = weights.module_variables(tmod)
    fs, ts = weights.flatten(_np_tree(bsj)), weights.flatten(tv["batch_stats"])
    assert set(fs) == set(ts)
    for k in fs:
        np.testing.assert_allclose(ts[k].numpy(), fs[k], atol=1e-6, rtol=1e-5, err_msg=k)
    fg = weights.flatten(_np_tree(gpj))
    g_all = max(np.abs(v).max() for v in fg.values())
    for name, p in tmod.named_parameters():
        k = name.replace(".", "/")
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        bound = 1e-4 * np.abs(fg[k]).max() + 1e-6 * g_all
        assert np.abs(got - fg[k]).max() <= bound, k


@pytest.mark.parametrize("single_pass", [False, True])
@pytest.mark.parametrize("serial_ema", [True, False])
@pytest.mark.parametrize("num_group_axes", [1, 2])
def test_grouped_batchnorm_matches_flax(single_pass, serial_ema, num_group_axes):
    rng = np.random.default_rng(7)
    shape = (3, 4, 5, 8) if num_group_axes == 1 else (3, 4, 2, 5, 6, 8)
    x = (2.0 + 3.0 * rng.standard_normal(shape)).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    jmod = jl.GroupedBatchNorm(num_group_axes, serial_ema=serial_ema, single_pass=single_pass)
    var = jmod.init(jax.random.PRNGKey(0), x, False)
    var = _perturbed_stats({
        "params": {"scale": 1 + 0.1 * jnp.arange(8.0), "bias": 0.05 * jnp.arange(8.0)},
        "batch_stats": var["batch_stats"],
    })
    tmod = tl.GroupedBatchNorm(8, num_group_axes, serial_ema=serial_ema, single_pass=single_pass)
    _compare(jmod, tmod, var, [x], cot)


def test_serial_ema_weights_late_groups_more():
    """The serial EMA is in C order (batch outer, county inner): the last
    group's statistics weigh most, as in the reference's serial loop."""
    bn = tl.GroupedBatchNorm(1, num_group_axes=2, single_pass=False)
    x = torch.zeros(1, 2, 4, 1)
    x[0, 1] = torch.tensor([0.0, 2.0, 0.0, 2.0])[:, None]  # group 1 mean 1
    bn(x, True)
    expected = 0.9 * 0.1 * 0.0 + 0.1 * 1.0  # group 0 first, then group 1
    assert abs(float(bn.mean) - expected) < 1e-7


@pytest.mark.parametrize("single_pass", [False, True])
def test_double_conv_matches_flax(single_pass):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 2, 8, 8, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 3, 2, 8, 8, 4)).astype(np.float32)
    jmod = jl.DoubleConv(4, bn_single_pass=single_pass)
    var = _perturbed_stats(jmod.init(jax.random.PRNGKey(1), x, False))
    _compare(jmod, tl.DoubleConv(3, 4, bn_single_pass=single_pass), var, [x], cot)


@pytest.mark.parametrize("pool", ["pallas", "reduce_window", "pairwise"])
def test_down_matches_flax(pool):
    """At W·C = 32·4 = 128 the pallas pool takes the kernel path on both
    sides; ReLU'd inputs make tied windows common."""
    rng = np.random.default_rng(2)
    x = np.maximum(rng.standard_normal((2, 2, 2, 32, 32, 4)), 0).astype(np.float32)
    cot = rng.standard_normal((2, 2, 2, 16, 16, 8)).astype(np.float32)
    jmod = jl.Down(8, pool=pool)
    var = _perturbed_stats(jmod.init(jax.random.PRNGKey(2), x, False))
    if pool == "reduce_window":
        x = x + 1e-3 * rng.standard_normal(x.shape).astype(np.float32)  # no ties
    _compare(jmod, tl.Down(4, 8, pool=pool), var, [x], cot)


@pytest.mark.parametrize("size", [8, 7])
def test_up_matches_flax(size):
    """ConvTranspose (spatially flipped kernel), pad-to-match on an odd
    skip, concat [skip, up], DoubleConv."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 2, 4, 4, 8)).astype(np.float32)
    skip = rng.standard_normal((2, 2, 2, size + 1, size + 1, 4)).astype(np.float32)
    cot = rng.standard_normal((2, 2, 2, size + 1, size + 1, 4)).astype(np.float32)
    jmod = jl.Up(4)
    var = _perturbed_stats(jmod.init(jax.random.PRNGKey(3), x, skip, False))
    _compare(jmod, tl.Up(8, 4, 4), var, [x, skip], cot)


def test_graph_wavenet_matches_flax():
    """The fused-path Graph WaveNet in train mode (dropout 0): start conv,
    8 layers of the forward_reference body with adaptive adjacency,
    per-sample BatchNorm over (N, T), skip sum and end convs."""
    rng = np.random.default_rng(4)
    b, n, t = 2, 5, 3
    x = rng.standard_normal((b, n, t, 320)).astype(np.float32)
    cot = rng.standard_normal((b, n, t, 256)).astype(np.float32)
    sup = np.eye(n, dtype=np.float32)[None]
    jmod = JaxGraphWaveNet(dropout=0.0, bn_single_pass=True)
    var = _perturbed_stats(jmod.init(jax.random.PRNGKey(4), x, sup, False))
    cfg = ModelConfig(compute_dtype="float32", gwnet=GWNetConfig(dropout=0.0))
    tmod = GraphWaveNet(cfg, n, 1)
    _compare(jmod, tmod, var, [x], cot, extra=(jnp.asarray(sup),), t_extra=(torch.from_numpy(sup),))


def test_sample_weight_raises():
    """sample_weight, refused before the mesh was ported, now masks the
    running-stat update: an all-ones row is the unmasked update, and a
    zero row leaves a group out (the full comparison with JAX's module is
    tests/test_torch_port_spmd.py)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2, 3, 4))
                         .astype(np.float32))
    plain, ones, half = (tl.GroupedBatchNorm(4, 2) for _ in range(3))
    y = plain(x, True)
    torch.testing.assert_close(ones(x, True, sample_weight=torch.ones(2)), y)
    torch.testing.assert_close(ones.mean, plain.mean)
    torch.testing.assert_close(ones.var, plain.var)
    half(x, True, sample_weight=torch.tensor([1.0, 0.0]))
    first = tl.GroupedBatchNorm(4, 2)
    first(x[:1], True)
    torch.testing.assert_close(half.mean, first.mean)
    torch.testing.assert_close(half.var, first.var)


def test_dropout_keep_rate_scale_and_seed():
    """Kept values are scaled by 1/(1−p); the keep rate is 1−p within 5σ
    of a binomial; the mask is a function of the generator's seed."""
    p, n = 0.3, 200_000
    x = torch.ones(n)
    y = tl.dropout(x, p, True, torch.Generator().manual_seed(3))
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    sigma = (n * p * (1 - p)) ** 0.5
    assert abs(int(kept.sum()) - n * (1 - p)) < 5 * sigma
    again = tl.dropout(x, p, True, torch.Generator().manual_seed(3))
    other = tl.dropout(x, p, True, torch.Generator().manual_seed(4))
    assert torch.equal(y, again) and not torch.equal(y, other)
    assert torch.equal(tl.dropout(x, p, False, None), x)
