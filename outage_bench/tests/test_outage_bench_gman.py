"""The GMAN st-GNN family (reference/st_gnn/gman.py) and the cells that run
it (gman.forecast_b1) or that came with it (gwnet.sweep_b16), on the CPU at
test size: the family found by name, the variables tree it lays out
against the program's, its reference forward at each quant, the cells'
runs and a planted fault (the temporal attention's causal mask dropped),
and the readers of the gman.* spans on synthetic traces.

    python -m pytest outage_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
import torch

from multimodal_outage_tpu_torch.core import tracing
from outage_bench import inputs, spec
from outage_bench.drivers import DRIVERS
from outage_bench.reference import model as ref
from outage_bench.run import run_cell
from outage_bench.tests.tiny import tiny_cell
from outage_bench.trace import Trace

SEED = 2**31 + 4243
READERS = ["gman_device_ms.encoder.forecast", "gman_device_ms.transform.forecast",
           "gman_device_ms.decoder.forecast", "gman_launches.forecast"]


def _tiny(name: str = "gman.forecast_b1", compute_dtype: str = "float32"):
    """The cell at test size, GMAN cut to K = 2 heads of d = 4, L = 1 and
    the tiny horizon's window."""
    cell = tiny_cell(name, compute_dtype)
    m = cell.config["model"]
    if m["st_gnn"] == "gman":
        m["gman"].update(num_heads=2, head_dim=4, num_blocks=1,
                         steps=2 * cell.config["data"]["horizon"])
    return cell


def test_the_gman_family_is_found_by_name():
    model = spec.load_cell("gman.forecast_b1").config["model"]
    fam = ref.family(model)
    assert fam.__doc__.startswith("GMAN") and fam.MIX_KEYS == ()
    assert fam.support_kind(model) == "identity" and fam.teacher(model) is None
    assert fam.dropout_sites(model, 1, 67, 7) == []
    assert model["gman"] == {"num_heads": 8, "head_dim": 8, "num_blocks": 3, "steps": 14}


def test_variables_layout_and_make_variables_build_its_tree():
    from multimodal_outage_tpu_torch.weights import flatten, init_variables

    from outage_bench.program import model_config

    for cell in (spec.load_cell("gman.forecast_b1"), _tiny()):
        m, d = cell.config["model"], cell.config["data"]
        theirs = {k: tuple(v.shape) for k, v in flatten(init_variables(
            model_config(m), d["horizon"], d["n_counties"], 0, d["image_size"])).items()}
        ours = {p: s for p, s, _ in inputs.variables_layout(m, d["n_counties"], d["image_size"], 1)}
        assert ours == theirs
    v = inputs.make_variables(m, 4, 16, 1, SEED, "cpu")
    st = v["params"]["st_gnn"]
    assert st["spatial_embedding"].shape == (4, 8) and st["spatial_embedding"].std() > 0.5
    assert "bias" not in st["encoder"]["block0"]["fusion"]["xs"]
    assert v["batch_stats"]["st_gnn"]["te"]["fc1"]["bn"]["var"].min() > 0


@pytest.mark.parametrize("quant", ["bf16", "fp8"])
def test_the_reference_forward_runs_at_each_quant(quant):
    cell = _tiny()
    drv = DRIVERS["closed_loop"](cell, SEED, "cpu")
    drv.setup()
    idx = drv.next_idx()
    batch = drv.ref_batch(drv.positions, idx)
    sup = torch.from_numpy(drv.supports)
    with torch.no_grad():
        y = ref.forward(drv.variables, batch["x"], batch["date_feats"], sup, drv.model)
        yq = ref.forward(drv.variables, batch["x"], batch["date_feats"], sup, drv.model,
                         quant=getattr(ref, quant))
    assert yq.shape == y.shape and torch.isfinite(yq).all()
    assert 0 < float((yq - y).norm() / y.norm()) < (0.05 if quant == "bf16" else 0.5)


@pytest.mark.parametrize("name", ["gman.forecast_b1", "gwnet.sweep_b16"])
def test_the_new_cells_run_and_are_correct(name):
    r = run_cell(_tiny(name), SEED, 0.3, False, device="cpu")
    assert r["correct"] is True and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in spec.load_cell(name).end_to_end}


def _no_causal_mask(monkeypatch):
    from multimodal_outage_tpu_torch.models import gman

    sdpa = torch.nn.functional.scaled_dot_product_attention
    monkeypatch.setattr(gman.F, "scaled_dot_product_attention",
                        lambda q, k, v, is_causal=False: sdpa(q, k, v))


def test_the_family_reference_sees_the_causal_mask(monkeypatch):
    """The engine's st-GNN (FoldedGMAN) against the family's reference
    forward on the same z, in float32: the same to rounding, and far apart
    once the program's temporal attention sees every step. (On the
    forecast the fault moves the output by about as much as bf16 rounding
    does at this size: PERF.md, section 2.)"""
    from multimodal_outage_tpu_torch.core.config import GMANConfig
    from multimodal_outage_tpu_torch.models.gman import FoldedGMAN

    cell = _tiny()
    m, d = cell.config["model"], cell.config["data"]
    v = inputs.make_variables(m, d["n_counties"], d["image_size"], 1, SEED, "cpu")
    st, sbs = v["params"]["st_gnn"], v["batch_stats"]["st_gnn"]
    cin = m["feature_vector_size"] + m["time_embed_size"]
    z = torch.randn(2, d["n_counties"], d["horizon"], cin,
                    generator=torch.Generator().manual_seed(5))
    fam = ref.family(m)
    with torch.no_grad():
        want = fam.forward(z, st, sbs, None, m, False, None, ref.ident)
        engine = FoldedGMAN(st, sbs, GMANConfig(**m["gman"]), d["horizon"], "cpu", torch.float32)
        sound = engine(z)
        _no_causal_mask(monkeypatch)
        fault = engine(z)
    rel = lambda a: float((a - want).norm() / want.norm())  # noqa: E731
    assert rel(sound) < 1e-5 < 1e-2 < rel(fault)


# --- the readers of the gman.* spans ------------------------------------------------


def _span(i, name, s, e, root=None, device_ms=None):
    return tracing.Span(i, root, root or i, name, int(s * 1e9), int(e * 1e9), device_ms)


# two forwards on [1, 3) and [5, 8), each with its GMAN stages
SPANS = [_span(1, "engine.forward", 1.0, 3.0),
         _span(2, "gman.forward", 1.2, 2.0, 1, 0.7), _span(3, "gman.encoder", 1.2, 1.5, 1, 0.3),
         _span(4, "gman.transform", 1.5, 1.6, 1, 0.1), _span(5, "gman.decoder", 1.6, 2.0, 1, 0.3),
         _span(6, "engine.forward", 5.0, 8.0),
         _span(7, "gman.forward", 5.5, 6.5, 6, 0.9), _span(8, "gman.encoder", 5.5, 5.9, 6, 0.5),
         _span(9, "gman.transform", 5.9, 6.0, 6, 0.1), _span(10, "gman.decoder", 6.0, 6.5, 6, 0.3)]
DEV = [("k", 0.0, 9.0)]
HOST = [("cudaLaunchKernel", 1.25, 1.26), ("cudaLaunchKernel", 1.7, 1.71),
        ("cuLaunchKernel", 2.5, 2.51), ("cudaMemcpyAsync", 5.6, 5.61),
        ("cudaGraphLaunch", 5.7, 5.71), ("cudaLaunchKernel", 6.1, 6.11),
        ("cudaLaunchKernel", 6.2, 6.21),
        ("cudaStreamSynchronize", 6.3, 6.4)]


def _ctx(monkeypatch, recorded=SPANS):
    monkeypatch.setattr(tracing, "spans", lambda: list(recorded))
    return SimpleNamespace(trace=Trace(window_s=10.0, device=list(DEV), host=list(HOST)))


def test_gman_readers_on_synthetic_spans(monkeypatch):
    ctx = _ctx(monkeypatch)
    read = lambda m: spec.reader(m)(ctx)  # noqa: E731
    assert read("gman_device_ms.encoder.forecast") == pytest.approx(0.4)
    assert read("gman_device_ms.transform.forecast") == pytest.approx(0.1)
    assert read("gman_device_ms.decoder.forecast") == pytest.approx(0.3)
    # 2 launches in the first gman.forward, 4 in the second, a graph's one
    # call among them (the sync is none; 2.5 lies in engine.forward but
    # outside gman.forward)
    assert read("gman_launches.forecast") == pytest.approx(3.0)


@pytest.mark.parametrize("metric", READERS)
def test_a_gman_reader_without_spans_is_left_out(metric, monkeypatch, capsys):
    assert metric in {m["name"] for m in spec.load_cell("gman.forecast_b1").per_layer}
    assert metric not in {m["name"] for m in spec.load_cell("gwnet.forecast_b1").per_layer}
    assert spec.reader(metric)(_ctx(monkeypatch, recorded=[])) is None
    assert "no span named 'gman." in capsys.readouterr().err
    # a program without the tracer (an older commit): left out, no error
    import multimodal_outage_tpu_torch.core as core

    monkeypatch.delattr(core, "tracing")
    monkeypatch.setitem(sys.modules, "multimodal_outage_tpu_torch.core.tracing", None)
    assert spec.reader(metric)(_ctx(monkeypatch)) is None
