"""GMAN, the port's third st-GNN (models/gman.py), held on the CPU in
float32 to the benchmark's plain reference (outage_bench/reference/
st_gnn/gman.py, which imports nothing of the port) at a small size
(N = 5, T = Q = 3, 16² frames, K = 2 heads of d = 4, L = 1): the eval
forward of ModifiedUNet and of the serving engine's folded path, and a
train step's loss and every gradient. Also its causal mask, its
attention counter, its BatchNorm's pad rows, its variables tree against
the reference's layout, the CLI, and the mesh (gloo ranks): a
data-parallel step with a padded batch and a time-split step against the
one-device step, and ServingModel(mesh=) with T split.

Tolerances: the port and the reference compute the same float32
arithmetic in other orders (cuDNN-free conv2d vs einsum, SDPA vs
matmul-softmax, a folded BatchNorm vs its four steps), so they agree to
float32 rounding grown by the depth of the network: 1e-5 relative on a
forward, 1e-5 on the loss, 1e-4 of the larger of a leaf's and the median
leaf's gradient norm (a bias that a BatchNorm cancels has a gradient of
rounding alone).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics

import numpy as np
import pytest
import torch

from multimodal_outage_tpu_torch import cli, weights
from multimodal_outage_tpu_torch.core.config import GMANConfig, ModelConfig
from multimodal_outage_tpu_torch.core.mesh import MeshShape
from multimodal_outage_tpu_torch.models import gman
from multimodal_outage_tpu_torch.models.fusion import build_model
from multimodal_outage_tpu_torch.parallel import launch
from multimodal_outage_tpu_torch.serving import ServingModel
from multimodal_outage_tpu_torch.train.state import create_train_state
from multimodal_outage_tpu_torch.train.steps import make_train_step
from outage_bench import inputs
from outage_bench.reference import model as ref
from outage_bench.reference.st_gnn import gman as ref_gman

import spmd_rank_steps as R

N, T, H = 5, 3, 16
GMAN = GMANConfig(num_heads=2, head_dim=4, num_blocks=1, steps=2 * T)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw) -> ModelConfig:
    base = dict(st_gnn="gman", compute_dtype="float32", base_channels=2, depth=2,
                feature_vector_size=16, time_embed_size=8, encoder_dropout=0.0, gman=GMAN)
    return ModelConfig(**{**base, **kw})


def _model_dict(cfg: ModelConfig) -> dict:
    """The configuration as the reference reads it (a configuration file's
    "model" group)."""
    import dataclasses

    return dataclasses.asdict(cfg)


def _variables(cfg: ModelConfig, seed: int = 0) -> dict:
    """init_variables with every BatchNorm's scale, shift and running
    statistics spread about their initial values, so that folding them
    matters."""
    v = weights.init_variables(cfg, T, N, seed=seed, image_size=H)
    g = torch.Generator().manual_seed(seed)
    out = {}
    for coll in ("params", "batch_stats"):
        flat = weights.flatten(v[coll])
        for k, x in flat.items():
            r = torch.randn(x.shape, generator=g)
            if k.endswith("/var"):
                flat[k] = x * torch.exp(0.2 * r)
            elif k.endswith("/mean") or re.search(r"/bn\d?/(scale|bias)$", k):
                flat[k] = x + 0.1 * r
        out[coll] = weights.unflatten(flat)
    return out


def _batch(b: int = 2, seed: int = 1) -> dict:
    g = torch.Generator().manual_seed(seed)
    feats = torch.zeros(b, T, 6)
    feats[..., 3:] = torch.tensor([2022.0, 9.0, 26.0])
    feats[..., 5] += torch.arange(T, dtype=torch.float32)
    return {"x": torch.randn(b, N, T, H, H, 1, generator=g),
            "y": torch.randn(b, N, T, H, H, 1, generator=g), "date_feats": feats}


SUP = torch.eye(N)[None]


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("path", ["module", "engine"])
def test_eval_forward_matches_reference(path):
    cfg, v, batch = _cfg(), _variables(_cfg()), _batch()
    with torch.no_grad():
        want = ref.forward(v, batch["x"], batch["date_feats"], SUP, _model_dict(cfg))
        if path == "module":
            m = weights.load_variables(build_model(cfg, T, N, H), v).eval()
            got = m(batch["x"], batch["date_feats"], SUP, train=False)
        else:
            got = ServingModel(cfg, v, SUP.numpy(), horizon=T, device="cpu")(
                batch["x"], batch["date_feats"])
    assert got.shape == want.shape == (2, N, T, H, H, 1)
    assert _rel(got, want) < 1e-5


def test_train_step_matches_reference():
    """One train step: loss and every gradient leaf against the reference's
    autograd, S fixed on both sides (the port gives it no gradient and Adam
    does not move it). At B = 4: this step moves a gradient leaf by ~6e-6
    when its input moves by 1e-7 relative; at B = 2 (seed 1) by 2%, as
    far as the port is from the reference there (an ill-conditioned
    step, not a fault: the loss agrees to the last bit)."""
    cfg = _cfg()
    v, batch = _variables(cfg), _batch(4)
    m = weights.load_variables(build_model(cfg, T, N, H), v)
    state = create_train_state(m)
    s0 = m.st_gnn.spatial_embedding.detach().clone()
    metrics = make_train_step(m)(state, batch, SUP, 1e-3, 7)
    got = {k.replace(".", "/"): p.grad for k, p in m.named_parameters() if p.grad is not None}
    assert torch.equal(m.st_gnn.spatial_embedding, s0)

    flat = {k: t.clone().requires_grad_(not k.startswith(("date2vec/", "st_gnn/spatial_embedding")))
            for k, t in weights.flatten(v["params"]).items()}
    tree = {"params": weights.unflatten(flat), "batch_stats": v["batch_stats"]}
    y = ref.forward(tree, batch["x"], batch["date_feats"], SUP, _model_dict(cfg), train=True,
                    drop=lambda a: a)
    loss = (y - batch["y"]).square().mean()
    loss.backward()
    want = {k: t.grad for k, t in flat.items() if t.grad is not None}
    assert set(got) == set(want)
    assert any(k.startswith("st_gnn/encoder/block0/temporal") for k in got)
    assert abs(float(metrics["loss"]) - float(loss.detach())) <= 1e-5 * float(loss.detach())
    med = statistics.median(float(g.norm()) for g in want.values())
    for k, g in want.items():
        assert float((got[k] - g).norm()) <= 1e-4 * max(float(g.norm()), med), k


@pytest.mark.parametrize("t", [1, 2])
def test_temporal_attention_is_causal(t):
    """Changing the st-GNN's input at step t leaves the temporal attention's
    outputs at the steps before t unchanged, and moves those at t and
    after."""
    m = gman.GMAN(24, 16, N, T, GMAN).eval()
    weights.load_variables(m, {k: v["st_gnn"] for k, v in _variables(_cfg()).items()})
    seen = []
    m.encoder["block0"].temporal.register_forward_hook(lambda mod, a, out: seen.append(out))
    z = torch.randn(2, N, T, 24, generator=torch.Generator().manual_seed(3))
    z2 = z.clone()
    z2[:, :, t] += 1.0
    with torch.no_grad():
        m(z)
        m(z2)
    a, b = seen
    assert torch.equal(a[:, :, :t], b[:, :, :t])
    assert not torch.allclose(a[:, :, t:], b[:, :, t:])


# --- the engine's st-GNN at gman_fl67's widths, in bf16 -------------------------------

FL67 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "outage_bench",
                    "configs", "gman_fl67.json")
# The serving engine's bf16 st-GNN against the float32 reference, each gap
# over the gap that bf16 operands give the reference on the same z: the
# benchmark's forecast measure, read at the st-GNN's output, where the
# U-Net does not drown GMAN's own error. Limits between the sound engine
# and the two it must catch, on the H100 over 16 seeds (PERF.md, section 2):
# the reference with float8 operands (a lower precision than bf16) and the
# engine with the temporal attention's causal mask dropped.
ST_LIMITS = {"rms_vs_bf16": 3.0, "max_vs_bf16": 4.0}


@contextlib.contextmanager
def unmasked():
    """A planted fault: the temporal attention sees every step."""
    fn = gman.attention
    gman.attention = lambda q, k, v, kind: fn(q, k, v, "spatial" if kind == "temporal" else kind)
    gman.attention.calls = fn.calls
    try:
        yield
    finally:
        gman.attention = fn


def _fl67_st_gnn(seed: int, device: str):
    """(model group, engine factory, z): gman_fl67's st-GNN (GMANConfig()
    over 67 counties and 7 days in and out) with the benchmark's variables
    for `seed` (outage_bench/inputs.py), and z drawn from it: relu'd
    N(0, 1) bottleneck features beside N(0, 1) Date2Vec."""
    with open(FL67) as f:
        m = json.load(f)["model"]
    n, t = 67, 7
    v = inputs.make_variables(m, n, 16, 1, seed, device)
    st, sbs = v["params"]["st_gnn"], v["batch_stats"]["st_gnn"]
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.cat([torch.randn(1, n, t, m["feature_vector_size"], generator=g, device=device).relu(),
                   torch.randn(1, n, t, m["time_embed_size"], generator=g, device=device)], -1)
    engine = lambda: gman.FoldedGMAN(st, sbs, GMANConfig(**m["gman"]), t, device,  # noqa: E731
                                     torch.bfloat16)
    return m, st, sbs, engine, z


def st_gnn_readings(seed: int, device: str) -> dict:
    """{"sound", "fp8", "unmasked"}: (rms_vs_bf16, max_vs_bf16) of the
    engine's FoldedGMAN in bf16 (_fl67_st_gnn), of the reference with
    float8 operands and of an engine built with the causal mask dropped
    (on the card it captures its graphs under the fault), against the
    float32 reference."""
    m, st, sbs, engine, z = _fl67_st_gnn(seed, device)
    with torch.no_grad(), ref.tf32_off():
        want, y16, y8 = (ref_gman.forward(z, st, sbs, None, m, False, None, q)
                         for q in (ref.ident, ref.bf16, ref.fp8))
        sound = engine()(z.bfloat16()).float()
        with unmasked():
            fault = engine()(z.bfloat16()).float()
    d16 = y16 - want
    return {k: (float((y - want).norm() / d16.norm()),
                float((y - want).abs().max() / d16.abs().max()))
            for k, y in (("sound", sound), ("fp8", y8), ("unmasked", fault))}


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("seed", [2**31 + 11, 3_141_592_653, 4_000_000_007])
def test_engine_st_gnn_holds_to_reference_at_published_widths(device, seed):
    """The benchmark's forecast check cannot see GMAN (the forecast moves by
    1e-4 when the mask is dropped, under bf16 rounding: PERF.md, section
    2), so the st-GNN is held here, on the card through its SDPA kernels:
    the sound engine within both limits, the float8 control and the
    unmasked engine past one."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (README: the port's tests on the H100)")
    r = st_gnn_readings(seed, device)
    within = lambda x: all(a <= lim for a, lim in zip(x, ST_LIMITS.values()))  # noqa: E731
    assert within(r["sound"]), r
    assert not within(r["fp8"]) and not within(r["unmasked"]), r


@pytest.mark.cuda
def test_engine_graphs_replay_the_eager_stages():
    """On the card FoldedGMAN replays its three stages from CUDA graphs
    captured at the first call: each forward, of a new z each, gives
    exactly what the eager stages give on it (the same kernels, z copied
    into the captured input), and one shape captures once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (README: the port's tests on the H100)")
    _, _, _, engine, _ = _fl67_st_gnn(2**31 + 11, "cuda")
    eng = engine()
    with torch.no_grad():
        for seed in (1, 2, 3):
            z = _fl67_st_gnn(seed, "cuda")[-1].bfloat16()
            got = eng(z).clone()
            want = z
            for stage in eng._eager(1, 67):
                want = stage(want)
            assert torch.equal(got, want), float((got - want).abs().max())
    assert list(eng._graphs) == [(1, 67, 7, 320)]


@pytest.mark.parametrize("path", ["module", "engine"])
def test_attention_calls_per_forward(path):
    """L blocks in the encoder and L in the decoder, each one spatial and one
    temporal attention, and one transform attention between them."""
    cfg = _cfg(gman=GMANConfig(num_heads=2, head_dim=4, num_blocks=2, steps=2 * T))
    v, batch = _variables(cfg), _batch(1)
    if path == "module":
        fn = weights.load_variables(build_model(cfg, T, N, H), v).eval()
        call = lambda: fn(batch["x"], batch["date_feats"], SUP)  # noqa: E731
    else:
        eng = ServingModel(cfg, v, SUP.numpy(), horizon=T, device="cpu")
        call = lambda: eng(batch["x"], batch["date_feats"])  # noqa: E731
    before = dict(gman.attention.calls)
    with torch.no_grad():
        call()
    calls = {k: gman.attention.calls[k] - before[k] for k in gman.KINDS}
    assert calls == {"spatial": 4, "temporal": 4, "transform": 1}


def test_batchnorm_leaves_pad_rows_out():
    """A batch with pad rows (sample weight 0) normalizes its valid rows and
    moves the running statistics as the batch of the valid rows alone."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, N, T, 8, generator=g)
    padded = torch.cat([x, 5.0 + x[:1]])
    a, b = gman.BatchNorm(8), gman.BatchNorm(8)
    ya = a(x, True)
    yb = b(padded, True, (torch.tensor([1.0, 1.0, 1.0, 0.0]), None))
    torch.testing.assert_close(yb[:3], ya, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b.mean, a.mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(b.var, a.var, rtol=1e-6, atol=1e-7)
    c = gman.BatchNorm(8)
    c(x, True, (torch.zeros(3), None))  # no valid row: the statistics stay
    assert torch.equal(c.mean, torch.zeros(8)) and torch.equal(c.var, torch.ones(8))


@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_init_variables_match_reference_layout(collection):
    """init_variables' st_gnn leaves and the reference family's layout: the
    same paths, shapes and order, collection by collection; S is of kind
    "node", N(0, 1)."""
    cfg = ModelConfig(st_gnn="gman")
    v = weights.init_variables(cfg, 7, 67, seed=0)
    ours = [(k, tuple(t.shape)) for k, t in weights.flatten(v[collection]).items()
            if k.startswith("st_gnn/")]
    lay = ref_gman.layout(_model_dict(cfg), 67, 1)
    theirs = [(p.split("/", 1)[1], s) for p, s, _ in lay if p.startswith(collection + "/")]
    assert ours == theirs
    assert ("params/st_gnn/spatial_embedding", (67, 64), "node") in lay
    n_params = sum(int(np.prod(s)) for p, s, _ in lay if p.startswith("params/"))
    assert 550_000 < n_params < 650_000  # ~0.6 M with S's 4,288
    full = inputs.variables_layout(_model_dict(cfg), 67, 128, 1)
    assert [x for x in full if "/st_gnn/" in x[0]] == lay


def test_engine_and_module_need_their_window():
    """GMAN's temporal embedding one-hot encodes 2·horizon steps: a config
    whose steps disagree with the horizon, or an input of another length,
    is refused."""
    with pytest.raises(ValueError, match="steps"):
        build_model(_cfg(gman=GMANConfig(steps=14)), T, N, H)
    m = gman.GMAN(24, 16, N, T, GMAN)
    with pytest.raises(ValueError, match="input steps"):
        m(torch.zeros(1, N, T + 1, 24))


def test_cli_parses_gman():
    ns = cli._parser().parse_args(["serve", "--st_gnn", "gman", "--horizon", "3", "--seed", "0"])
    cfg = cli._config(ns)
    assert cfg.model.st_gnn == "gman" and cfg.model.gman == GMANConfig(steps=6)
    assert cli._config(cli._parser().parse_args(["train"])).model.gman == GMANConfig()


KEYS = ("loss", "mae", "mape", "rmse")


def test_cli_train_evaluate_serve_gman(tiny_store_dir, tmp_path, monkeypatch):
    """train --st_gnn gman writes a checkpoint that evaluate reads back to
    the run's test metrics (==) and serve --checkpoint_path serves (BN
    folded: within 1e-3, as the other families' engines are held)."""
    monkeypatch.chdir(tmp_path)
    tiny = ["--st_gnn", "gman", "--data_dir", tiny_store_dir, "--dataset_range", "12",
            "--horizon", "3", "--image_size", "16", "--batch_size", "2", "--compute_dtype",
            "float32", "--device", "cpu"]
    run = cli.run(["train", *tiny, "--epochs", "1", "--job_id", "g"])
    config = json.load(open(tmp_path / "logs" / "g" / "config.json"))
    assert config["model"]["st_gnn"] == "gman" and config["model"]["gman"]["steps"] == 6
    base = ["--checkpoint_path", str(tmp_path / "logs" / "g" / "checkpoints"), "--case",
            "michael", *tiny]
    ev = cli.run(["evaluate", *base])
    assert ev["metrics"] == {k: run[f"test_{k}"] for k in KEYS}
    sv = cli.run(["serve", *base])
    for k in ("loss", "mae", "rmse"):
        np.testing.assert_allclose(sv["metrics"][k], ev["metrics"][k], rtol=1e-3, err_msg=k)


# --- the mesh (two gloo ranks) -----------------------------------------------------


@pytest.fixture(scope="module")
def mesh_runs():
    """Every mesh case in one world of two ranks: GMAN train steps on 2x1x1
    (a ragged batch of 3 padded to 4) and 1x1x2 (T split), and the mesh
    serving engine on 1x1x2; the one-device steps here."""
    t, n, h = R.GMAN_DIMS
    cfg = R.gman_config()
    v = weights.init_variables(cfg, t, n, seed=3, image_size=h)
    batches = {"b3": R.gman_batch(3), "b4": R.gman_batch(4)}
    got = launch.run(R.gman_mesh_cases, MeshShape(2, 1, 1), "cpu", (v, batches), progress=False)
    one = {k: R.one_device_step(cfg, v, batches[k], t, n, h) for k in batches}
    return got, one, v, batches


@pytest.mark.parametrize("case", [("2x1x1", "b3"), ("1x1x2", "b4")], ids=lambda c: c[0])
def test_mesh_step_equals_one_device_step(mesh_runs, case):
    got, one, _, _ = mesh_runs
    mesh, b = case
    r, want = got[f"step_{mesh}"], one[b]
    for k in ("loss", "mae", "rmse"):
        np.testing.assert_allclose(r["metrics"][k], want["metrics"][k], rtol=1e-5, err_msg=k)
    for k, s in want["stats"].items():
        np.testing.assert_allclose(r["stats"][k], s, rtol=1e-4, atol=1e-5, err_msg=k)
    g_all = max(float(np.abs(g).max()) for g in want["grads"].values())
    for k, g in want["grads"].items():
        gap = float(np.abs(r["grads"][k] - g).max()) / max(float(np.abs(g).max()), 1e-3 * g_all)
        assert gap <= 1e-4, k


def test_mesh_serving_engine_equals_the_single_device_engine(mesh_runs):
    got, _, v, batches = mesh_runs
    t, n, h = R.GMAN_DIMS
    b = batches["b4"]
    want = ServingModel(R.gman_config(), v, np.eye(n, dtype=np.float32)[None], horizon=t,
                        device="cpu")(torch.from_numpy(b["x"]), torch.from_numpy(b["date_feats"]))
    assert _rel(torch.from_numpy(got["serve_1x1x2"]), want) < 1e-5
