"""The port's non-fused Graph WaveNet branches, reference_view_quirk and
svd_aptinit (models/gwnet.py) on the CPU, against the JAX package's
GraphWaveNet on the same numpy inputs, with weights carried across by
weights.py.

Branches (module level, N=4, T=3, B=2, narrow widths, 2 blocks × 2
layers): kernel_size 2 and 3 (the dilated gated TCN with the
receptive-field pad), gcn_bool=False at kernel_size 1 and 2 (residual
1×1s), addaptadj=False with no supports, and reference_view_quirk on the
fused path (plain and per-layer op) and the non-fused one. Each is held to
JAX in eval mode at the JAX serving bar (atol 5e-5, rtol 1e-4, float32)
and in train mode with dropout 0 (output at the same bar, BN running
statistics atol 1e-6 / rtol 1e-5, gradients of a fixed cotangent within
1e-4 of each leaf's largest entry + 1e-6 of the largest of all).

One ModifiedUNet train step at kernel_size 2 with svd_aptinit (node
embeddings from the SVD of the first of two dual-random-walk supports;
U-Net depth 3 at 16² frames) is held to JAX's jitted step at the bars of
tests/test_torch_port_train.py and for its reasons: loss and metrics
rtol 1e-5; each gradient leaf within 1e-4·max|g_leaf| + 1e-7 (the
diffusion and skip gradients are near-cancelling sums whose summation
order differs between the packages); BN statistics atol 1e-6 / rtol
1e-5; updated parameters atol 1e-6 where the gradient stands above that
tolerance and 2·lr elsewhere (Adam's first step moves an entry by ±lr with
the sign of its gradient, noise included). Depth 3 keeps 3·2·2 = 12
values in each BatchNorm group of the deepest level; at depth 4 and 16²
they hold 3, and there both packages' gradients sit ~1.5e-4 of a leaf's
largest entry from the same step in float64, above this bar, while at
depth 3 they sit within 1.1e-5 of it and 4.4e-5 of each other. The node
embeddings' gradients are ill-conditioned in both (E1·E2 rebuilds the
support's zeros to ±rounding, on relu's kink) and agree with each other,
not with float64.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu import cli as jax_cli
from multimodal_outage_tpu.core import metrics as jax_metrics
from multimodal_outage_tpu.core.config import GWNetConfig as JaxGWNetConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.core.config import small_test_config
from multimodal_outage_tpu.models import gwnet as jax_gwnet
from multimodal_outage_tpu.models.fusion import build_model as jax_build_model
from multimodal_outage_tpu.train.state import make_optimizer as jax_make_optimizer
from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
from multimodal_outage_tpu_torch.core.config import Config, GWNetConfig, ModelConfig
from multimodal_outage_tpu_torch.data.adjacency import build_supports, load_adjacency_csv
from multimodal_outage_tpu_torch.data.synthetic import generate_store
from multimodal_outage_tpu_torch.models import gwnet
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.ops.gwnet_layer import fused_gwnet_layer
from multimodal_outage_tpu_torch.train import loop
from multimodal_outage_tpu_torch.train.state import create_train_state
from multimodal_outage_tpu_torch.train.steps import make_train_step

B, N, T, D_IN, OUT = 2, 4, 3, 16, 12
TOL = dict(atol=5e-5, rtol=1e-4)
SMALL = dict(residual_channels=8, dilation_channels=8, skip_channels=16, end_channels=16,
             blocks=2, layers=2, node_embed_dim=4)
# name: (GWNetConfig fields, static supports, port's use_pallas)
CASES = {
    "k2": (dict(kernel_size=2), 1, False),
    "k3": (dict(kernel_size=3), 2, False),
    "nogcn_k1": (dict(gcn_bool=False), 1, False),
    "nogcn_k2": (dict(gcn_bool=False, kernel_size=2), 1, False),
    "noadapt_nosup": (dict(addaptadj=False), 0, False),
    "quirk_fused": (dict(reference_view_quirk=True), 1, False),
    "quirk_fused_pallas": (dict(reference_view_quirk=True), 1, True),
    "quirk_k2": (dict(reference_view_quirk=True, kernel_size=2), 2, False),
}
RING = np.roll(np.eye(N, dtype=np.float32), 1, axis=1) + np.roll(np.eye(N, dtype=np.float32), -1, 0)
RING[0, 2] = 1.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op (the CLI test took 324 s beside five workers, 4 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _case(name):
    """One JAX init per branch: (flax module, variables with non-trivial BN
    statistics, x, cotangent, supports or None, the port's config)."""
    fields, n_static, pallas = CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((B, N, T, D_IN)).astype(np.float32)
    cot = rng.standard_normal((B, N, T, OUT)).astype(np.float32)
    sup = None
    if n_static:
        adj = rng.random((N, N)).astype(np.float32) * RING
        sup = np.stack(build_supports(adj, "doubletransition")[:n_static])
    jmod = jax_gwnet.GraphWaveNet(out_dim=OUT, dropout=0.0, bn_single_pass=True, **SMALL,
                                  **fields)
    var = jax.jit(jmod.init, static_argnums=3)(jax.random.PRNGKey(len(name)), x, sup, False)
    bs = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        var["batch_stats"],
    )
    var = {"params": var["params"], "batch_stats": bs}
    cfg = ModelConfig(compute_dtype="float32", feature_vector_size=OUT,
                      time_embed_size=D_IN - OUT,
                      gwnet=GWNetConfig(dropout=0.0, use_pallas=pallas, **SMALL, **fields))
    return jmod, var, x, cot, sup, cfg


def _port(name):
    """A fresh port module holding the branch's JAX variables."""
    _, var, _, _, sup, cfg = _case(name)
    n_static = 0 if sup is None else sup.shape[0]
    return weights.load_variables(gwnet.GraphWaveNet(cfg, N, n_static),
                                  weights.from_flax(_np(var)))


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("name", list(CASES))
def test_eval_forward_matches_flax(name):
    jmod, var, x, _, sup, _ = _case(name)
    tmod = _port(name)
    fields, n_static, pallas = CASES[name]
    assert tmod.fused == (fields.get("kernel_size", 1) == 1 and fields.get("gcn_bool", True)
                          and bool(n_static or fields.get("addaptadj", True)))
    assert (tmod._layer is fused_gwnet_layer) == pallas
    want = np.asarray(jax.jit(jmod.apply, static_argnums=3)(var, x, sup, False))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), _t(sup), False)
    assert got.shape == (B, N, T, OUT)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_train_mode_matches_flax(name):
    """Dropout 0: the output, the BN running statistics (over a T that
    shrinks from layer to layer on the dilated path) and the gradients of a
    fixed cotangent for x and every parameter."""
    jmod, var, x, cot, sup, _ = _case(name)
    tmod = _port(name)

    def f(params, xx):
        y, mut = jmod.apply({"params": params, "batch_stats": var["batch_stats"]}, xx, sup,
                            True, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    @jax.jit
    def f_vjp(params, xx):
        (y, bs), vjp = jax.vjp(f, params, xx)
        return y, bs, vjp((jnp.asarray(cot), jax.tree.map(jnp.zeros_like, bs)))

    yj, bsj, (gpj, gxj) = f_vjp(var["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tmod(xt, _t(sup), True)
    yt.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gxj), **TOL)
    fs = weights.flatten(_np(bsj))
    ts = weights.flatten(weights.module_variables(tmod)["batch_stats"])
    assert set(fs) == set(ts)
    for k in fs:
        np.testing.assert_allclose(ts[k].numpy(), fs[k], atol=1e-6, rtol=1e-5, err_msg=k)
        assert not np.array_equal(fs[k], weights.flatten(_np(var["batch_stats"]))[k])
    fg = weights.flatten(_np(gpj))
    g_all = max(np.abs(v).max() for v in fg.values())
    names = {k.replace(".", "/") for k, _ in tmod.named_parameters()}
    assert names == set(fg)
    for name_, p in tmod.named_parameters():
        k = name_.replace(".", "/")
        got = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        assert np.abs(got - fg[k]).max() <= 1e-4 * np.abs(fg[k]).max() + 1e-6 * g_all, k


@pytest.mark.parametrize("name", list(CASES))
def test_weight_round_trip_is_exact(name):
    """JAX tree → port module → JAX tree: every leaf bitwise, the nested
    non-fused names (filter_conv{i}/kernel [k, C, Cd], gconv{i}/mlp,
    residual_conv{i}) and no node embeddings without gcn_bool."""
    _, var, _, _, _, cfg = _case(name)
    back = weights.flatten(_np(weights.module_variables(_port(name))))
    want = weights.flatten(_np(var))
    assert set(back) == set(want)
    for k in want:
        assert back[k].dtype == np.float32 and np.array_equal(back[k], want[k]), k
    g = cfg.gwnet
    assert ("params/nodevec1" in want) == (g.gcn_bool and g.addaptadj)
    if g.kernel_size > 1:
        assert want["params/filter_conv0/kernel"].shape == (g.kernel_size, 8, 8)


def _flax_shapes(jcfg, n_static):
    x = jnp.zeros((1, N, 2, 16, 16, 1))
    sup = jnp.stack([jnp.eye(N)] * n_static)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda: jax_build_model(jcfg, 2).init(
        {"params": key, "dropout": key}, x, jnp.zeros((1, 2, 6)), sup, train=False))
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("fields", [
    dict(kernel_size=2), dict(gcn_bool=False), dict(gcn_bool=False, kernel_size=2),
    dict(kernel_size=3, adjtype="doubletransition", addaptadj=False),
], ids=["k2", "nogcn", "nogcn_k2", "k3_doubletransition_noadapt"])
def test_init_variables_matches_flax_tree(fields):
    jcfg = small_test_config().model
    jcfg = dataclasses.replace(jcfg, gwnet=dataclasses.replace(jcfg.gwnet, **fields))
    want = _flax_shapes(jcfg, 2 if fields.get("adjtype") == "doubletransition" else 1)
    cfg = ModelConfig(compute_dtype="float32", gwnet=GWNetConfig(**fields))
    got = {k: tuple(v.shape) for k, v in
           weights.flatten(weights.init_variables(cfg, 2, N, seed=0, image_size=16)).items()}
    assert got == want


@pytest.mark.parametrize("adj", ["random", "florida"])
def test_svd_aptinit_equals_jax_bitwise(adj):
    if adj == "random":
        a, d = np.random.default_rng(3).random((6, 6)).astype(np.float32), 3
    else:
        a, d = build_supports(load_adjacency_csv()[1], "doubletransition")[0], 10
    for got, want in zip(gwnet.svd_aptinit(a, d), jax_gwnet.svd_aptinit(a, d)):
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    got = gwnet.svd_aptinit(torch.from_numpy(np.asarray(a)), d)
    assert all(np.array_equal(g, w) for g, w in zip(got, jax_gwnet.svd_aptinit(a, d)))


def test_install_aptinit_equals_jax_bitwise():
    """The nodevecs JAX's install_aptinit puts into a flax tree, bitwise; the
    rest of the tree untouched; a no-op without an adaptive adjacency; a
    clear error where the nodes are fewer than node_embed_dim."""
    _, var, _, _, sup, _ = _case("k2")
    params = weights.from_flax(_np(var["params"]))
    want = jax_gwnet.install_aptinit({"st_gnn": var["params"]}, sup[0], 4)["st_gnn"]
    got = gwnet.install_aptinit({"st_gnn": params}, torch.from_numpy(sup[0]), 4)["st_gnn"]
    for k in ("nodevec1", "nodevec2"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
        assert not np.array_equal(got[k].numpy(), params[k].numpy())
    assert all(got[k] is params[k] for k in params if not k.startswith("nodevec"))
    tree = {"st_gnn": weights.from_flax(_np(_case("nogcn_k2")[1]["params"]))}
    assert gwnet.install_aptinit(tree, sup[0], 4) is tree
    with pytest.raises(ValueError, match="node_embed_dim"):
        gwnet.install_aptinit({"st_gnn": params}, sup[0][:3, :3], 4)


def test_fit_installs_the_svd_nodevecs():
    """fit's initial variables with svd_aptinit: the nodevecs are
    svd_aptinit of the first static support, bitwise, the other leaves
    those of init_variables; without it, init_variables' own."""
    g = GWNetConfig(kernel_size=2, adjtype="doubletransition", node_embed_dim=4)
    sup = np.stack(build_supports(RING, "doubletransition"))
    for randomadj in (False, True):
        cfg = Config(model=ModelConfig(gwnet=dataclasses.replace(g, randomadj=randomadj)))
        loop.check_supported(cfg)
        got = loop._initial_variables(cfg, N, sup)["params"]
        plain = weights.init_variables(cfg.model, 7, N, cfg.train.seed)["params"]
        e = gwnet.svd_aptinit(sup[0], 4) if not randomadj else (
            plain["st_gnn"]["nodevec1"].numpy(), plain["st_gnn"]["nodevec2"].numpy())
        for k, want in zip(("nodevec1", "nodevec2"), e):
            assert np.array_equal(got["st_gnn"][k].numpy(), want)
        assert torch.equal(got["st_gnn"]["start_conv"]["kernel"],
                           plain["st_gnn"]["start_conv"]["kernel"])


LR, H = 1e-3, 16


@pytest.fixture(scope="module")
def k2_step():
    """One ModifiedUNet train step at kernel_size 2 with svd_aptinit over two
    dual-random-walk supports, float32, dropout 0: JAX's step op by op (its
    loss, metrics, BN statistics, gradients and Adam update) and the
    port's from the same tree, nodevecs installed by each package."""
    gw = dict(kernel_size=2, randomadj=False, adjtype="doubletransition", dropout=0.0, **SMALL)
    jcfg = JaxModelConfig(compute_dtype="float32", encoder_dropout=0.0, depth=3,
                          gwnet=JaxGWNetConfig(**gw))
    tcfg = ModelConfig(compute_dtype="float32", encoder_dropout=0.0, depth=3,
                       gwnet=GWNetConfig(**gw))
    rng = np.random.default_rng(11)
    feats = np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (B, T, 1))
    feats[..., 5] += np.arange(T, dtype=np.float32)
    batch = {"x": rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32),
             "y": rng.standard_normal((B, N, T, H, H, 1)).astype(np.float32),
             "date_feats": feats}
    sup = np.stack(build_supports(rng.random((N, N)).astype(np.float32) * RING,
                                  "doubletransition"))
    model = jax_build_model(jcfg, T)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(2)
    init = jax.jit(functools.partial(model.init, train=False))
    random_params = init({"params": key, "dropout": key}, jbatch["x"], jbatch["date_feats"],
                         jnp.asarray(sup))
    bs = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        random_params["batch_stats"])
    random_params = random_params["params"]
    params = jax_gwnet.install_aptinit(random_params, sup[0], SMALL["node_embed_dim"])

    @jax.jit
    def step(p):  # the step's loss, gradients and Adam update (JAX train/steps.py:97-116)
        def loss_fn(p):
            yhat, mut = model.apply({"params": p, "batch_stats": bs}, jbatch["x"],
                                    jbatch["date_feats"], jnp.asarray(sup), train=True,
                                    rngs={"dropout": key}, mutable=["batch_stats"])
            return jax_metrics.mse(yhat, jbatch["y"]), (yhat, mut["batch_stats"])

        (_, (yhat, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        tx = jax_make_optimizer()
        updates, _ = tx.update(grads, tx.init(p), p)
        new_p = jax.tree.map(lambda a, u: a + u * jnp.float32(LR), p, updates)
        return jax_metrics.regression_metrics(yhat, jbatch["y"]), grads, new_p, new_bs

    jm, grads, new_params, new_bs = step(params)

    tparams = gwnet.install_aptinit(weights.from_flax(_np(random_params)), sup[0],
                                    SMALL["node_embed_dim"])
    tmodel = weights.load_variables(build_model(tcfg, T, N, H),
                                    {"params": tparams, "batch_stats": weights.from_flax(_np(bs))})
    tm = make_train_step(tmodel)(create_train_state(tmodel),
                                 {k: torch.from_numpy(v) for k, v in batch.items()},
                                 torch.from_numpy(sup), LR, 0)
    return {
        "jax_metrics": {k: float(v) for k, v in jm.items()},
        "port_metrics": {k: float(v) for k, v in tm.items()},
        "jax_grads": weights.flatten(_np(grads)),
        "port_grads": {k.replace(".", "/"): (p.grad if p.grad is not None
                                             else torch.zeros_like(p)).numpy()
                       for k, p in tmodel.named_parameters()},
        "jax_new": weights.flatten(_np({"params": new_params, "batch_stats": new_bs})),
        "port_new": weights.flatten(weights.module_variables(tmodel)),
        "old": weights.flatten(_np({"params": params, "batch_stats": bs})),
        "installed": [tparams["st_gnn"][k] for k in ("nodevec1", "nodevec2")],
        "jax_installed": [params["st_gnn"][k] for k in ("nodevec1", "nodevec2")],
    }


def _check_loss_and_metrics(step):
    j, t = step["jax_metrics"], step["port_metrics"]
    assert set(j) == set(t) == {"loss", "mae", "mape", "rmse"}
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
    for got, want in zip(step["installed"], step["jax_installed"]):
        assert np.array_equal(got.numpy(), np.asarray(want))


def _check_every_gradient_leaf(step):
    jg, tg = step["jax_grads"], step["port_grads"]
    assert set(jg) == set(tg) and "st_gnn/gconv0/mlp/kernel" in jg
    for k in jg:
        assert np.abs(tg[k] - jg[k]).max() <= 1e-4 * np.abs(jg[k]).max() + 1e-7, k
    assert np.abs(jg["st_gnn/nodevec1"]).max() > 0
    assert np.abs(jg["st_gnn/filter_conv3/kernel"]).max() > 0


def _check_batchnorm_running_stats(step):
    jn, tn, old = step["jax_new"], step["port_new"], step["old"]
    keys = [k for k in jn if k.startswith("batch_stats/")]
    assert len(keys) == 2 * (14 + 4)  # mean, var of 14 U-Net and 4 Graph WaveNet BNs
    for k in keys:
        np.testing.assert_allclose(tn[k].numpy(), jn[k], atol=1e-6, rtol=1e-5, err_msg=k)
        assert not np.array_equal(jn[k], old[k]), k


def _check_updated_params(step):
    jn, tn, jg = step["jax_new"], step["port_new"], step["jax_grads"]
    for k in (k for k in jn if k.startswith("params/")):
        g = np.abs(jg[k[len("params/"):]])
        d = np.abs(tn[k].numpy() - jn[k])
        tol = 1e-4 * g.max() + 1e-7
        signal = (g > tol) & (g * g > LR * 1e-8 * tol / 5e-7)
        assert (d[signal] <= 1e-6).all(), k
        assert (d <= 2 * LR + 1e-7).all(), k


@pytest.mark.parametrize(
    "check",
    [_check_loss_and_metrics, _check_every_gradient_leaf, _check_batchnorm_running_stats,
     _check_updated_params],
    ids=["loss_and_metrics", "every_gradient_leaf", "batchnorm_running_stats", "updated_params"],
)
def test_kernel_size_2_svd_aptinit_step_matches_jax(k2_step, check):
    check(k2_step)


NEW_FLAGS = ["--no_gcn", "--svd_aptinit", "--gwnet_kernel_size", "2"]


@pytest.mark.parametrize("argv", [
    ["train", *NEW_FLAGS],
    ["evaluate", "--checkpoint_path", "c", "--gwnet_kernel_size", "3", "--svd_aptinit"],
    ["serve", "--seed", "1", "--no_gcn", "--adjtype", "transition"],
], ids=lambda a: a[0])
def test_new_flags_map_onto_the_config_as_jax_build_config(argv):
    ns = cli._parser().parse_args(argv)
    ours = json.dumps(dataclasses.asdict(cli._config(ns)), default=str, sort_keys=True)
    theirs = json.dumps(dataclasses.asdict(jax_cli._build_config(ns)), default=str,
                        sort_keys=True)
    assert ours == theirs
    assert cli._config(ns).model.gwnet != GWNetConfig()


def test_cli_train_evaluate_serve_kernel_size_2(tmp_path, monkeypatch):
    """train --gwnet_kernel_size 2 --svd_aptinit --adjtype doubletransition
    for one epoch on the CPU (10 counties, so the 10 node embeddings fit
    the SVD), then evaluate of its checkpoint (its test metrics exactly)
    and serve --checkpoint_path (the eval-mode module, not the stack
    kernel: within rtol 1e-3 of evaluate, the U-Net's BN folded)."""
    store = str(tmp_path / "store")
    generate_store(store, n_counties=10, image_size=H, margin=12, seed=0)
    monkeypatch.chdir(tmp_path)
    common = ["--data_dir", store, "--dataset_range", "8", "--horizon", "3", "--image_size",
              str(H), "--batch_size", "2", "--device", "cpu", "--gwnet_kernel_size", "2",
              "--svd_aptinit", "--adjtype", "doubletransition"]
    run = cli.run(["train", "--epochs", "1", "--job_id", "k2", *common])
    ckpt = str(tmp_path / "logs" / "k2" / "checkpoints")
    ev = cli.run(["evaluate", "--checkpoint_path", ckpt, "--case", "michael", *common])
    assert ev["metrics"] == {k: run[f"test_{k}"] for k in ("loss", "mae", "mape", "rmse")}
    sv = cli.run(["serve", "--checkpoint_path", ckpt, "--case", "michael", *common])
    for k in ("loss", "mae", "rmse"):
        np.testing.assert_allclose(sv["metrics"][k], ev["metrics"][k], rtol=1e-3, err_msg=k)
    tree = CheckpointManager(ckpt).restore()
    assert tree["params"]["st_gnn"]["filter_conv0"]["kernel"].shape == (2, 32, 32)
