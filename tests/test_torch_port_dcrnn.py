"""The port's DCRNN (models/dcrnn.py, ops/dcrnn_stack.py, the dcrnn
serving engine) on the CPU against the JAX package: the flax DCRNN module
in eval mode, its packer, and its whole-stack Pallas kernel in interpret
mode — the same numpy inputs and weights, float32, at the JAX tests'
own small shapes (tests/test_dcrnn_stack.py). Bar: atol 5e-5 / rtol 1e-4
(summation order only)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.core.config import DCRNNConfig as JaxDCRNNConfig
from multimodal_outage_tpu.core.config import ModelConfig as JaxModelConfig
from multimodal_outage_tpu.models.dcrnn import DCRNN as JaxDCRNN
from multimodal_outage_tpu.models.fusion import build_model as jax_build_model
from multimodal_outage_tpu.ops import dcrnn_stack_pallas as jdsm
from multimodal_outage_tpu.serving import ServingModel as JaxServingModel
from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.config import DCRNNConfig, ModelConfig
from multimodal_outage_tpu_torch.data.adjacency import model_supports
from multimodal_outage_tpu_torch.models.dcrnn import DCRNN
from multimodal_outage_tpu_torch.ops import dcrnn_stack as dsm
from multimodal_outage_tpu_torch.serving import ServingModel

N, T, DIN, DOUT, UNITS = 6, 4, 12, 10, 8
TOL = dict(atol=5e-5, rtol=1e-4)


def _module_case(b=2, n_supports=2, layers=2, k=2, seed=0):
    """A flax DCRNN's variables, and numpy inputs and row-stochastic
    supports made from `seed`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, N, T, DIN)).astype(np.float32)
    logits = rng.standard_normal((n_supports, N, N))
    sup = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    m = JaxDCRNN(output_dim=DOUT, horizon=T, rnn_units=UNITS, num_rnn_layers=layers,
                 max_diffusion_step=k, dtype=jnp.float32)
    variables = m.init(jax.random.PRNGKey(seed), x, sup, train=False)
    return m, jax.tree.map(np.asarray, variables), x, sup


def _port_module(variables, n_supports, layers, k):
    m = DCRNN(DIN, DOUT, horizon=T, rnn_units=UNITS, num_rnn_layers=layers,
              max_diffusion_step=k, n_supports=n_supports)
    return weights.load_variables(m, weights.from_flax(variables))


@pytest.mark.parametrize("n_supports,k,layers", [(1, 2, 2), (2, 2, 2), (2, 1, 3), (1, 1, 2)])
def test_module_matches_flax(n_supports, k, layers):
    m, variables, x, sup = _module_case(n_supports=n_supports, layers=layers, k=k)
    want = np.asarray(m.apply(variables, x, sup, train=False))
    with torch.no_grad():
        got = _port_module(variables, n_supports, layers, k)(
            torch.from_numpy(x), torch.from_numpy(sup), train=False)
    assert tuple(got.shape) == (2, N, T, DOUT)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_module_raises_without_supports_and_on_teacher_forcing():
    """Without supports the module raises. Teacher forcing in train mode
    no longer raises: at p = 1 every decoder step after the first is fed
    the target, so the output differs from the self-fed eval forward
    (tests/test_torch_port_dcrnn_train.py holds it to the JAX package)."""
    m = DCRNN(DIN, DOUT, horizon=T, rnn_units=UNITS, n_supports=1, teacher_forcing=0.5)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    x = torch.randn(1, N, T, DIN, generator=g)
    with pytest.raises(ValueError, match="supports"):
        m(x, None)
    sup, y = torch.eye(N)[None], torch.randn(1, N, T, DOUT, generator=g)
    with torch.no_grad():
        fed = m(x, sup, train=True, targets=y, tf_prob=1.0)
        own = m(x, sup, train=False)
    assert torch.equal(fed[:, :, 0], own[:, :, 0]) and not torch.equal(fed, own)


def _packed(variables, n_supports, layers=2, k=2, pkg=dsm):
    params = weights.from_flax(variables)["params"] if pkg is dsm else variables["params"]
    return pkg.dcrnn_stack_params(
        params, num_rnn_layers=layers, max_diffusion_step=k,
        n_supports=n_supports, input_dim=DIN, output_dim=DOUT, rnn_units=UNITS,
    )


@pytest.mark.parametrize("layers,k", [(2, 2), (3, 1)])
def test_packer_matches_jax_leaf_for_leaf(layers, k):
    _, variables, _, sup = _module_case(layers=layers, k=k)
    got, want = _packed(variables, 2, layers, k), _packed(variables, 2, layers, k, jdsm)
    assert len(got["cells"]) == len(want["cells"]) == 2 * layers
    for gc, wc in zip(got["cells"], want["cells"]):
        assert len(gc) == len(wc) == 6
        for g, w in zip(gc, wc):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for key in ("proj_w", "proj_b"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("b", [1, 2])
def test_plain_stack_matches_jax_kernel_interpret(b):
    """stack_forward_reference and the wrapper on CPU tensors against the
    JAX whole-stack kernel in interpret mode, and against the module."""
    m, variables, x, sup = _module_case(b=b, seed=b)
    want = np.asarray(jdsm.dcrnn_stack_forward(
        jnp.asarray(x), jnp.asarray(sup), _packed(variables, 2, pkg=jdsm), horizon=T,
        rnn_units=UNITS, interpret=True))
    sp = _packed(variables, 2)
    kw = dict(horizon=T, rnn_units=UNITS)
    xt, st = torch.from_numpy(x), torch.from_numpy(sup)
    before = dsm.dcrnn_stack_forward.launches
    for got in (dsm.stack_forward_reference(xt, st, sp, **kw), dsm.dcrnn_stack_forward(xt, st, sp, **kw)):
        assert tuple(got.shape) == (b, N, T, DOUT)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert dsm.dcrnn_stack_forward.launches == before  # the CPU runs no kernel
    np.testing.assert_allclose(want, np.asarray(m.apply(variables, x, sup, train=False)), **TOL)


def test_plain_stack_rounds_where_the_kernel_rounds():
    """In bfloat16 the plain version rounds states and outputs to bf16: its
    output is bf16 and off the float32 run by bf16-sized errors only."""
    _, variables, x, sup = _module_case(b=1)
    sp = _packed(variables, 2)
    kw = dict(horizon=T, rnn_units=UNITS)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = dsm.stack_forward_reference(xt, torch.from_numpy(sup), sp, **kw)
    f32 = dsm.stack_forward_reference(xt.float(), torch.from_numpy(sup), sp, **kw)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - f32).abs().max())
    assert 0 < err < 0.05 * float(f32.abs().max())


# (K, N) of the bf16 kernel's projections: full width (layer 0's x part
# Dx0=320 and the decoder's Dout=256 onto the 3U=192 gate|candidate
# columns, layer 1's x part, the h part onto 2U, r⊙h onto U, the output
# projection U→Dout) and tiny ones it pads (U=8, Dout=12, Dx=16, U=12)
FRAG_SHAPES = [(320, 192), (256, 192), (64, 192), (64, 128), (64, 64), (64, 256),
               (16, 24), (8, 16), (8, 8), (8, 12), (12, 20), (24, 40)]


@pytest.mark.parametrize("k,n", FRAG_SHAPES)
def test_fragments_read_through_the_index_map_give_the_product(k, n):
    """term @ w with w read from the packed buffer element by element
    through fragment_slot equals term @ w exactly; unpacking gives back w
    and zeros in the padding."""
    rng = np.random.default_rng(k * 1000 + n)
    w = torch.from_numpy(rng.standard_normal((3, k, n)).astype(np.float32)).to(torch.bfloat16)
    term = torch.from_numpy(rng.standard_normal((3, 80, k)).astype(np.float32)).to(torch.bfloat16)
    f = dsm.pack_fragments(w)
    kp, np_ = -(-k // 16) * 16, -(-n // 8) * 8
    assert tuple(f.shape) == (3, kp // 16, np_ // 8, 32, 4) and f.is_contiguous()
    s, q, lane, e = dsm.fragment_slot(np.arange(k)[:, None], np.arange(n)[None, :])
    read = f[:, torch.from_numpy(s), torch.from_numpy(q), torch.from_numpy(lane), torch.from_numpy(e)]
    assert torch.equal(term.float() @ read.float(), term.float() @ w.float())
    full = dsm.unpack_fragments(f, kp, np_)
    assert torch.equal(full[:, :k, :n], w)
    assert not full[:, k:].any() and not full[:, :, n:].any()
    # a lane's four values: rows 2t, 2t+1, 2t+8, 2t+9 of column g
    g, t = 3, 2
    want = [w[1, r, g] if r < k and g < n else 0 for r in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
    assert [float(v) for v in f[1, 0, 0, 4 * g + t]] == [float(v) for v in want]


@pytest.mark.parametrize("units,dx0,dout", [(64, 320, 256), (8, 16, 12), (12, 24, 20)])
def test_stack_fragments_lay_out_every_projection(units, dx0, dout):
    """stack_params_to in bf16 adds the fragments: per cell the x part of
    the gates and the candidate side by side, the h part, the r⊙h part,
    and the output projection; float32 adds none."""
    rng = np.random.default_rng(units)
    r = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    nt, u = 5, units
    cells = [(r(nt, dx, 2 * u), r(nt, u, 2 * u), r(1, 2 * u), r(nt, dx, u), r(nt, u, u), r(1, u))
             for dx in (dx0, u, dout, u)]
    sp = {"cells": cells, "proj_w": r(u, dout), "proj_b": r(1, dout)}
    assert "frags" not in dsm.stack_params_to(sp, "cpu", torch.float32)
    bf = dsm.stack_params_to(sp, "cpu", torch.bfloat16)
    g8, c8 = -(-2 * u // 8) * 8, -(-u // 8) * 8
    for (wx, wh, wr), (gx, gh, _, cx, ch, _) in zip(bf["frags"]["cells"], bf["cells"]):
        dx = gx.shape[1]
        x_cols = dsm.unpack_fragments(wx, dx, g8 + c8)
        assert torch.equal(x_cols[..., :2 * u], gx) and torch.equal(x_cols[..., g8:g8 + u], cx)
        assert not x_cols[..., 2 * u:g8].any() and not x_cols[..., g8 + u:].any()
        assert torch.equal(dsm.unpack_fragments(wh, u, 2 * u), gh)
        assert torch.equal(dsm.unpack_fragments(wr, u, u), ch)
    assert torch.equal(dsm.unpack_fragments(bf["frags"]["proj"], u, dout)[0], bf["proj_w"])


def test_flops_split_into_chains_and_projections():
    """At full width (one B=1 forward) the projections are ~75% of the
    multiply-adds; the two parts sum to the whole."""
    args = (1, 67, 7, 7, 320, 256, 64, 2, 2, 2)
    parts = [dsm.flops(*args, part=p) for p in ("chains", "proj")]
    assert sum(parts) == dsm.flops(*args)
    assert 0.7 < parts[1] / sum(parts) < 0.8


H = 16


def _engine_case(b, seed=5):
    jcfg = JaxModelConfig(compute_dtype="float32", st_gnn="dcrnn")
    model = jax_build_model(jcfg, horizon=2)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 4, 2, H, H, 1)).astype(np.float32)
    feats = np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (b, 2, 1))
    feats[..., 5] += np.arange(2, dtype=np.float32)
    sup = model_supports(ModelConfig(st_gnn="dcrnn"), 4)  # dual random walk: S=2
    key = jax.random.PRNGKey(seed)
    variables = model.init({"params": key, "dropout": key}, x, feats, sup, train=False)
    bs = jax.tree.map(
        lambda v: v + 0.3 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        variables["batch_stats"],
    )
    return jcfg, model, {"params": variables["params"], "batch_stats": bs}, x, feats, sup


@pytest.mark.parametrize("b", [1, 2])
def test_engine_matches_jax_engine_and_flax_eval(b):
    """At B=1 the JAX engine takes its DCRNN kernel (interpret mode), at
    B=2 its scan module; the port takes its kernel path at both."""
    jcfg, model, variables, x, feats, sup = _engine_case(b)
    assert sup.shape == (2, 4, 4)
    y_flax = np.asarray(model.apply(variables, x, feats, sup, train=False))
    jserve = JaxServingModel(jcfg, variables, jnp.asarray(sup), interpret=True, dcrnn_stack=True,
                             horizon=2)
    y_jax = np.asarray(jserve(jnp.asarray(x), jnp.asarray(feats)))
    tvars = weights.from_flax(jax.tree.map(np.asarray, variables))
    cfg = ModelConfig(compute_dtype="float32", st_gnn="dcrnn")
    for stack in (True, False):
        serve = ServingModel(cfg, tvars, torch.from_numpy(sup), horizon=2, device="cpu",
                             dcrnn_stack=stack)
        y = serve(torch.from_numpy(x), torch.from_numpy(feats))
        assert y.dtype == torch.float32 and tuple(y.shape) == (b, 4, 2, H, H, 1)
        np.testing.assert_allclose(y.numpy(), y_jax, **TOL)
        np.testing.assert_allclose(y.numpy(), y_flax, **TOL)


def test_engine_bf16_runs_and_needs_supports():
    cfg = ModelConfig(st_gnn="dcrnn")
    var = weights.init_variables(cfg, 2, 4, seed=0, image_size=H)
    sup = torch.from_numpy(model_supports(cfg, 4))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4, 2, H, H, 1)).astype(np.float32))
    a = ServingModel(cfg, var, sup, horizon=2, device="cpu")(x, torch.zeros(2, 2, 6))
    b = ServingModel(cfg, var, sup, horizon=2, device="cpu", reference=True)(x, torch.zeros(2, 2, 6))
    assert a.dtype == torch.float32 and torch.isfinite(a).all() and torch.equal(a, b)
    with pytest.raises(ValueError, match="dcrnn_stack=True requires a supports array"):
        ServingModel(cfg, var, None, horizon=2, device="cpu")
    with pytest.raises(ValueError, match="DCRNN requires a supports array"):
        ServingModel(cfg, var, None, horizon=2, device="cpu", dcrnn_stack=False)


def _flax_shapes(jcfg, n, image_size, n_static):
    x = jnp.zeros((1, n, 2, image_size, image_size, 1))
    sup = jnp.stack([jnp.eye(n)] * n_static)
    key = jax.random.PRNGKey(0)
    tree = jax.eval_shape(lambda: jax_build_model(jcfg, 2).init(
        {"params": key, "dropout": key}, x, jnp.zeros((1, 2, 6)), sup, train=False))
    return {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("filter_type,n_static", [("dual_random_walk", 2), ("random_walk", 1)])
def test_init_variables_matches_flax_tree(filter_type, n_static):
    jcfg = JaxModelConfig(st_gnn="dcrnn", dcrnn=JaxDCRNNConfig(filter_type=filter_type))
    want = _flax_shapes(jcfg, 4, 16, n_static)
    cfg = ModelConfig(st_gnn="dcrnn", dcrnn=DCRNNConfig(filter_type=filter_type))
    tree = weights.init_variables(cfg, 2, 4, seed=0, image_size=16)
    got = {k: tuple(v.shape) for k, v in weights.flatten(tree).items()}
    assert got == want
    assert "st_gnn" not in tree["batch_stats"]
    st = tree["params"]["st_gnn"]
    assert torch.equal(st["encoder"]["cell0"]["gates"]["proj"]["bias"], torch.ones(128))
    assert not st["decoder"]["cell1"]["candidate"]["proj"]["bias"].any()


def test_cli_serve_dcrnn_on_cpu(tiny_store_dir, capsys):
    args = ["serve", "--st_gnn", "dcrnn", "--data_dir", tiny_store_dir, "--dataset_range", "12",
            "--horizon", "3", "--image_size", "16", "--batch_size", "2", "--seed", "0",
            "--max_batches", "2", "--latency_stats"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["forwards"] >= 2
    assert all(np.isfinite(v) for v in out["metrics"].values())
    assert out["latency"]["p50_ms"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.run(args)
