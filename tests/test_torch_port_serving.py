"""The port's serving engine on the CPU (plain versions of both kernels)
against the JAX package's ServingModel with its Pallas kernels in
interpret mode, and against the flax eval forward — same variables, same
numpy inputs, float32 — at the JAX package's own serving bar
(tests/test_serving.py: atol 5e-5, rtol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.models.fusion import build_model
from multimodal_outage_tpu.serving import ServingModel as JaxServingModel
from multimodal_outage_tpu_torch import weights
from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
from multimodal_outage_tpu_torch.ops.double_conv import fused_double_conv, kernel_takes
from multimodal_outage_tpu_torch.serving import ServingModel


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, T, H = 4, 2, 16


def _variables_and_inputs(b, seed=5, **cfg_kw):
    cfg = JaxModelConfig(compute_dtype="float32", **cfg_kw)
    model = build_model(cfg, horizon=T)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, N, T, H, H, 1)).astype(np.float32)
    feats = np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (b, T, 1))
    feats[..., 5] += np.arange(T, dtype=np.float32)
    sup = np.eye(N, dtype=np.float32)[None]
    key = jax.random.PRNGKey(seed)
    variables = model.init({"params": key, "dropout": key}, x, feats, sup, train=False)
    # non-trivial batch stats so BN folding is exercised
    bs = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        variables["batch_stats"],
    )
    variables = {"params": variables["params"], "batch_stats": bs}
    return cfg, model, variables, x, feats, sup


@pytest.mark.parametrize("b", [1, 2])
def test_serving_matches_jax_engine_and_flax_eval(b):
    cfg, model, variables, x, feats, sup = _variables_and_inputs(b)
    y_flax = np.asarray(model.apply(variables, x, feats, sup, train=False))
    jserve = JaxServingModel(cfg, variables, jnp.asarray(sup), use_pallas=True, interpret=True)
    assert jserve.gwnet_stack  # the stack kernel is engaged
    y_jax = np.asarray(jserve(jnp.asarray(x), jnp.asarray(feats)))

    tvars = weights.from_flax(jax.tree.map(np.asarray, variables))
    serve = ServingModel(
        ModelConfig(compute_dtype="float32"), tvars, torch.from_numpy(sup),
        horizon=T, device="cpu",
    )
    y = serve(torch.from_numpy(x), torch.from_numpy(feats))
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, N, T, H, H, 1)
    np.testing.assert_allclose(y.numpy(), y_jax, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(y.numpy(), y_flax, atol=5e-5, rtol=1e-4)


def test_narrow_unet_routes_per_level_and_matches_jax_engine():
    """base_channels=2: the levels of C = 2 (the stem and the last
    expansion) go to the plain version, the rest to the kernel, chosen at
    engine build; the forward matches the JAX engine."""
    cfg, model, variables, x, feats, sup = _variables_and_inputs(2, seed=7, base_channels=2)
    jserve = JaxServingModel(cfg, variables, jnp.asarray(sup), use_pallas=True, interpret=True)
    y_jax = np.asarray(jserve(jnp.asarray(x), jnp.asarray(feats)))
    tvars = weights.from_flax(jax.tree.map(np.asarray, variables))
    serve = ServingModel(ModelConfig(compute_dtype="float32", base_channels=2), tvars,
                         torch.from_numpy(sup), horizon=T, device="cpu")
    assert [fn is fused_double_conv for fn in serve.double_conv_fns] == [False] + [True] * 7 + [False]
    y = serve(torch.from_numpy(x), torch.from_numpy(feats))
    np.testing.assert_allclose(y.numpy(), y_jax, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("cin,c,dtype,takes", [
    (1, 4, torch.bfloat16, True), (32, 64, torch.bfloat16, True), (1, 2, torch.bfloat16, False),
    (128, 256, torch.bfloat16, False), (6, 6, torch.float32, False), (32, 64, torch.float32, True),
    (4, 4, torch.float16, False),
])
def test_kernel_takes(cin, c, dtype, takes):
    assert kernel_takes(cin, c, dtype) is takes


def test_per_layer_gwnet_engine_matches_jax_engine():
    """gwnet_stack=False, gwnet_pallas=True: the trainable Graph WaveNet in
    eval mode (BN not folded) through the per-layer op, against the JAX
    engine's module path with its per-layer Pallas kernel interpreted."""
    cfg, model, variables, x, feats, sup = _variables_and_inputs(2, seed=6)
    jserve = JaxServingModel(cfg, variables, jnp.asarray(sup), gwnet_stack=False,
                             gwnet_pallas=True, interpret=True, horizon=T)
    assert not jserve.gwnet_stack and jserve.gwnet_pallas
    y_jax = np.asarray(jserve(jnp.asarray(x), jnp.asarray(feats)))
    tvars = weights.from_flax(jax.tree.map(np.asarray, variables))
    for pallas in (True, False):
        serve = ServingModel(ModelConfig(compute_dtype="float32"), tvars, torch.from_numpy(sup),
                             horizon=T, device="cpu", gwnet_stack=False, gwnet_pallas=pallas)
        y = serve(torch.from_numpy(x), torch.from_numpy(feats))
        np.testing.assert_allclose(y.numpy(), y_jax, atol=5e-5, rtol=1e-4)


def test_reference_engine_equals_kernel_engine_on_cpu():
    """On CPU tensors the wrappers run the plain versions, so the engine
    and its reference=True twin agree exactly."""
    cfg = ModelConfig(compute_dtype="float32")
    var = weights.init_variables(cfg, T, N, seed=0, image_size=H)
    sup = torch.eye(N)[None]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, N, T, H, H, 1)).astype(np.float32))
    feats = torch.zeros(1, T, 6)
    a = ServingModel(cfg, var, sup, horizon=T, device="cpu")(x, feats)
    b = ServingModel(cfg, var, sup, horizon=T, device="cpu", reference=True)(x, feats)
    assert torch.equal(a, b)


def test_bf16_engine_runs_on_cpu():
    cfg = ModelConfig()
    var = weights.init_variables(cfg, T, N, seed=0, image_size=H)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, N, T, H, H, 1)).astype(np.float32))
    y = ServingModel(cfg, var, torch.eye(N)[None], horizon=T, device="cpu")(x, torch.zeros(2, T, 6))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()


@pytest.mark.parametrize(
    "cfg",
    [
        ModelConfig(gwnet=GWNetConfig(addaptadj=False)),  # and no static supports
        ModelConfig(gwnet=GWNetConfig(kernel_size=2)),
        ModelConfig(gwnet=GWNetConfig(gcn_bool=False)),
        ModelConfig(gwnet=GWNetConfig(reference_view_quirk=True)),
    ],
)
def test_unported_configs_raise(cfg):
    """The configs the engine refused before the non-fused Graph WaveNet
    branches were ported: each now builds an engine on the eval-mode
    module (the stack kernel does not apply to them) and gives a finite
    forecast. With addaptadj=False and no supports the layers are the
    residual 1×1s, the tree gcn_bool=False has."""
    no_support = not cfg.gwnet.addaptadj
    tree_cfg = ModelConfig(gwnet=GWNetConfig(gcn_bool=False)) if no_support else cfg
    var = weights.init_variables(tree_cfg, T, N, seed=0, image_size=H)
    sup = None if no_support else torch.eye(N)[None]
    serve = ServingModel(cfg, var, sup, horizon=T, device="cpu")
    assert not serve.gwnet_stack
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, N, T, H, H, 1)).astype(np.float32))
    y = serve(x, torch.zeros(1, T, 6))
    assert tuple(y.shape) == (1, N, T, H, H, 1) and torch.isfinite(y).all()


@pytest.mark.parametrize("gw,sup,kw", [
    (GWNetConfig(kernel_size=2), True, dict(gwnet_stack=True)),
    (GWNetConfig(gcn_bool=False), True, dict(gwnet_stack=True)),
    (GWNetConfig(addaptadj=False), False, dict(gwnet_stack=True)),
    (GWNetConfig(reference_view_quirk=True), True, dict(gwnet_stack=True)),
    (GWNetConfig(kernel_size=2), True, dict(gwnet_stack=False, gwnet_pallas=True)),
    (GWNetConfig(gcn_bool=False), True, dict(gwnet_pallas=True)),
    (GWNetConfig(), True, dict(gwnet_stack=True, gwnet_pallas=True)),
], ids=["stack_k2", "stack_nogcn", "stack_nosupport", "stack_quirk", "pallas_k2",
        "pallas_nogcn", "stack_and_pallas"])
def test_explicit_kernel_that_cannot_apply_raises(gw, sup, kw):
    """An explicit gwnet_stack=True or gwnet_pallas=True that its config
    cannot take raises ValueError; the engine never switches paths
    quietly. reference_view_quirk at kernel_size 1 takes the per-layer
    kernel (between the two reinterprets)."""
    with pytest.raises(ValueError, match="gwnet_stack=True|gwnet_pallas=True"):
        ServingModel(ModelConfig(gwnet=gw), {"params": {}, "batch_stats": {}},
                     torch.eye(N)[None] if sup else None, device="cpu", **kw)
    cfg = ModelConfig(gwnet=GWNetConfig(reference_view_quirk=True))
    var = weights.init_variables(cfg, T, N, seed=0, image_size=H)
    serve = ServingModel(cfg, var, torch.eye(N)[None], horizon=T, device="cpu", gwnet_pallas=True)
    assert not serve.gwnet_stack


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    var = weights.init_variables(ModelConfig(), T, N, seed=0, image_size=H)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingModel(ModelConfig(), var, torch.eye(N)[None], horizon=T)
