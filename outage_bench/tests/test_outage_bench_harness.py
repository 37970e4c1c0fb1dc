"""The harness on the CPU: the frozen counters against hand counts, the
inputs' layout against the program's, the seed's traffic, cells found by
name, the result line, the device-idle arithmetic and the no-JAX check.

    python -m pytest outage_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from outage_bench import counts, inputs, nojax, spec
from outage_bench.run import main, run_cell
from outage_bench.tests.tiny import tiny_cell
from outage_bench.trace import Trace, gaps, union_length

SEED = 2**31 + 977  # past 32 signed bits: seeds may be that large
CELLS = ["dcrnn.forecast_b1", "gwnet.train_b16", "gwnet.forecast_b1", "dcrnn.sweep_b16",
         "dcrnn.train_b16_tf"]


def test_double_conv_counts_by_hand():
    # 2 images of 4x4, 1 -> 4 channels: 2*16 pixels * 9 taps * (1*4 + 4*4) MACs
    assert counts.double_conv_flops(2, 4, 4, 1, 4) == 2 * 2 * 16 * 9 * 20
    # bf16: x (1 ch) + out (4 ch) per pixel, 9*4*(1+4) weights, 4 float32 vectors of 4
    assert counts.double_conv_bytes(2, 4, 4, 1, 4, 2) == 2 * (32 * 5 + 180) + 64
    cfg = spec.load_cell("gwnet.forecast_b1").config["model"]
    assert counts.double_conv_shapes(cfg, 128) == [
        (128, 128, 1, 4), (64, 64, 4, 8), (32, 32, 8, 16), (16, 16, 16, 32), (8, 8, 32, 64),
        (16, 16, 64, 32), (32, 32, 32, 16), (64, 64, 16, 8), (128, 128, 8, 4)]


def test_stack_counts_by_hand():
    m = spec.load_cell("gwnet.forecast_b1").config["model"]
    fl, nb = counts.gwnet_stack_counts(m, 1, 67, 7, 2, 2)
    # per layer: filter+gate 67*32*64, skip 67*32*256, diffusion 2*2*67^2*32,
    # gconv 67*5*32*32; start 67*320*32, ends 67*256*512 + 67*512*256
    per_layer = 67 * 32 * 64 + 67 * 32 * 256 + 4 * 67 * 67 * 32 + 67 * 160 * 32
    assert fl == 2 * 7 * (67 * 320 * 32 + 8 * per_layer + 2 * 67 * 256 * 512)
    assert nb == 2 * (7 * 67 * (320 + 256) + 2 * 67 * 67 + 320 * 32 + 32
                      + 8 * (2 * (32 * 32 + 32) + 32 * 256 + 256 + 160 * 32 + 32 + 64)
                      + 256 * 512 + 512 + 512 * 256 + 256)
    d = spec.load_cell("dcrnn.forecast_b1").config["model"]
    fl, nb = counts.dcrnn_stack_counts(d, 1, 67, 7, 7, 2, 2)
    # a cell's MACs: diffusion chains 2 supports * 2 steps * 67^2 * (x + h + r*h
    # widths), projections 5 terms * 67 * (x*192 + 64*128 + 64*64); encoder steps
    # (320 in) 32,743,168 + 11,680,512; decoder steps (256 in) 27,477,504 +
    # 11,680,512, the first (GO, no x) 6,414,848 + 11,680,512; output proj
    # 67*64*256 a step
    macs = 7 * 44_423_680 + 6 * 39_158_016 + 18_095_360 + 7 * 67 * 64 * 256
    assert fl == 2 * macs == 1_143_386_624
    # weights 368,832 + 123,072 (encoder) + 307,392 + 123,072 (decoder) + 16,640
    # (proj); x 67*7*320, y 67*7*256, supports 2*67^2
    assert nb == 2 * (939_008 + 150_080 + 120_064 + 8_978)
    assert round(counts.bound_s(fl, nb, counts.PEAKS["h100 80gb hbm3"]) * 1e3, 4) == 0.0012


def test_variables_layout_is_the_programs():
    from multimodal_outage_tpu_torch.weights import flatten, init_variables

    from outage_bench.program import model_config

    for name in ("gwnet.forecast_b1", "dcrnn.forecast_b1"):
        for cell in (spec.load_cell(name), tiny_cell(name)):
            m, d = cell.config["model"], cell.config["data"]
            n_static = inputs.static_supports(inputs.support_kind(m), d["n_counties"]).shape[0]
            theirs = {k: tuple(v.shape) for k, v in flatten(init_variables(
                model_config(m), d["horizon"], d["n_counties"], 0, d["image_size"])).items()}
            ours = {p: s for p, s, _ in inputs.variables_layout(m, d["n_counties"],
                                                                d["image_size"], n_static)}
            assert ours == theirs


def test_supports_are_the_programs():
    from multimodal_outage_tpu_torch.data.adjacency import model_supports

    from outage_bench.program import model_config

    for name in ("gwnet.forecast_b1", "dcrnn.forecast_b1"):
        m = spec.load_cell(name).config["model"]
        np.testing.assert_array_equal(inputs.static_supports(inputs.support_kind(m), 67),
                                      model_supports(model_config(m), 67))


def test_traffic_is_reproducible():
    cell = tiny_cell("dcrnn.forecast_b1")
    st = cell.traffic["store"]
    a = inputs.make_frames(st, 4, 16, SEED, "cpu")
    assert torch.equal(a, inputs.make_frames(st, 4, 16, SEED, "cpu"))
    assert not torch.equal(a, inputs.make_frames(st, 4, 16, SEED + 1, "cpu"))
    assert (a >= 0).all() and a.shape == (len(inputs.store_dates(st)), 4, 16, 16)
    va = inputs.make_variables(cell.config["model"], 4, 16, 2, SEED, "cpu")
    vb = inputs.make_variables(cell.config["model"], 4, 16, 2, SEED, "cpu")
    assert torch.equal(va["params"]["encoder"]["fc1"]["kernel"], vb["params"]["encoder"]["fc1"]["kernel"])
    from outage_bench.drivers import DRIVERS

    draws = []
    for _ in range(2):
        drv = DRIVERS["closed_loop"](cell, SEED, "cpu")
        drv.setup()
        draws.append([drv.next_idx().tolist() for _ in range(20)])
    assert draws[0] == draws[1]


def test_a_new_file_in_each_folder_is_found(tmp_path):
    here = tmp_path / "outage_bench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, sub), here / sub)
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    cfg = json.load(open(here / "configs" / "gwnet_fl67.json"))
    json.dump(cfg, open(here / "configs" / "gwnet_new.json", "w"))
    tr = json.load(open(here / "traffic" / "forecast_b1.json"))
    json.dump(dict(tr, batch=2), open(here / "traffic" / "forecast_b2.json", "w"))
    json.dump({"rel_rms": 1.0}, open(here / "limits" / "gwnet_new.forecast_b2.json", "w"))
    (here / "metrics" / "new_metric.x.py").write_text("def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "gwnet_new", "file": "outage_bench/configs/gwnet_new.json"})
    bench["workloads"].append({"name": "gwnet_new.forecast_b2", "config": "gwnet_new",
                               "traffic": "forecast_b2", "chips": 1})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "%",
                               "workloads": ["gwnet_new.forecast_b2"]})
    path = tmp_path / "BENCHMARK.json"
    json.dump(bench, open(path, "w"))
    cell = spec.load_cell("gwnet_new.forecast_b2", str(path), str(here))
    assert cell.traffic["batch"] == 2 and cell.limits == {"rel_rms": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    assert spec.reader("new_metric.x", str(here))(None) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}


STANDIN = '''"""A stand-in st-GNN family: a two-layer perceptron per position, no graph."""
from outage_bench.reference import model as ref

MIX_KEYS = ()


def support_kind(model):
    return "identity"


def teacher(model):
    return None


def dropout_sites(model, b, n, t):
    return [((b, n, t, model["standin"]["width"]), 0.5)]


def layout(model, n, n_static):
    w, f = model["standin"]["width"], model["feature_vector_size"]
    return (ref.dense_leaves("st_gnn/hidden", f + model["time_embed_size"], w)
            + ref.dense_leaves("st_gnn/out", w, f))


def forward(z, params, stats, supports, cfg, train, drop, q, teacher=None):
    h = ref.dense(z, params["hidden"], q, act=True)
    if train:
        h = drop(h)
    return ref.dense(h, params["out"], q)
'''


def test_a_new_st_gnn_family_is_added_by_files_alone(tmp_path, monkeypatch):
    """A family file in a directory of its own is loaded by the
    configuration's st_gnn, laid out, given its supports and dropout sites,
    and run through the reference's forward, eval and train."""
    from outage_bench import check
    from outage_bench.reference import model as ref

    (tmp_path / "standin.py").write_text(STANDIN)
    monkeypatch.setattr(ref, "FAMILIES", str(tmp_path))
    m = dict(tiny_cell("gwnet.forecast_b1").config["model"], st_gnn="standin",
             standin={"width": 5})
    b, n, t, s = 2, 4, 3, 16
    sup = inputs.static_supports(inputs.support_kind(m), n)
    layout = inputs.variables_layout(m, n, s, sup.shape[0])
    assert [p for p, _, _ in layout if "/st_gnn/" in p] == [
        "params/st_gnn/hidden/kernel", "params/st_gnn/hidden/bias",
        "params/st_gnn/out/kernel", "params/st_gnn/out/bias"]
    var = inputs.make_variables(m, n, s, sup.shape[0], SEED, "cpu")
    g = torch.Generator().manual_seed(1)
    x, feats = torch.randn((b, n, t, s, s, 1), generator=g), torch.zeros(b, t, 6)
    sites = check.dropout_sites(m, b, n, t, s)
    assert [shape for shape, _ in sites][1] == (b, n, t, 5)
    masks = iter(check.dropout_masks(3, 0, sites, "cpu"))
    drop = lambda a: torch.where(next(masks)[0], a / 0.5, torch.zeros(()))
    sup = torch.from_numpy(sup)
    for train in (False, True):
        y = ref.forward(var, x, feats, sup, m, train=train, drop=drop)
        assert y.shape == (b, n, t, s, s, 1) and torch.isfinite(y).all()
    assert next(masks, None) is None  # the encoder's, the family's, the decoder's


def test_an_unknown_st_gnn_fails_at_set_up_naming_the_file():
    from outage_bench.drivers import DRIVERS

    cell = tiny_cell("gwnet.forecast_b1")
    cell.config["model"]["st_gnn"] = "nosuch"
    drv = DRIVERS["closed_loop"](cell, SEED, "cpu")
    with pytest.raises(FileNotFoundError, match=r"st_gnn/nosuch\.py"):
        drv.setup()


def test_a_mix_sets_only_its_familys_training_knobs(tmp_path):
    tf, plain = spec.load_cell("dcrnn.train_b16_tf"), spec.load_cell("dcrnn.forecast_b1")
    assert tf.traffic["model"] == {"dcrnn": {"teacher_forcing": 1.0, "tf_decay_steps": 2000}}
    assert tf.config["model"]["dcrnn"] == dict(plain.config["model"]["dcrnn"], teacher_forcing=1.0,
                                               tf_decay_steps=2000)
    assert {k: v for k, v in tf.config.items() if k != "model"} == {
        k: v for k, v in plain.config.items() if k != "model"}
    assert spec.load_cell("gwnet.train_b16").config == spec.load_cell("gwnet.forecast_b1").config
    here = tmp_path / "outage_bench"
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(os.path.join(spec.HERE, sub), here / sub)
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        c["file"] = str(tmp_path / c["file"])
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    base = json.load(open(here / "traffic" / "train_b16_tf.json"))
    # a key the configuration lacks, a width, a top-level key, another family's knob
    for group in ({"dcrnn": {"no_such_knob": 1}}, {"dcrnn": {"rnn_units": 32}},
                  {"feature_vector_size": 128}, {"gwnet": {"dropout": 0.1}}):
        json.dump(dict(base, model=group), open(here / "traffic" / "train_b16_tf.json", "w"))
        with pytest.raises(KeyError, match=rf"model\.{spec._dotted(group)[0][0]}"):
            spec.load_cell("dcrnn.train_b16_tf", str(tmp_path / "BENCHMARK.json"), str(here))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_keys(name, trace):
    r = run_cell(tiny_cell(name), SEED, 0.3, bool(trace), device="cpu")
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    cell = spec.load_cell(name)
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"]) and set(r["breakdown"]) == {
            "device_ops", "idle_gaps"}
        # off the card only the host spans have something to read
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(r["checks"]) == set(cell.limits)
    json.dumps(r, allow_nan=False)


def test_device_idle_is_the_union_of_kernel_intervals():
    # two kernels overlap on [1, 2); a third runs alone; idle [3, 4) and [5, 6)
    dev = [("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("k3", 4.0, 5.0)]
    assert union_length([(s, e) for _, s, e in dev]) == 4.0  # a sum would read 5
    assert gaps([(s, e) for _, s, e in dev], 0.0, 6.0) == [(3.0, 4.0), (5.0, 6.0)]
    host = [("cudaLaunchKernel", 2.5, 3.5), ("cudaStreamSynchronize", 3.6, 4.2)]
    tr = Trace(window_s=6.0, device=dev, host=host)
    assert tr.busy_s == 4.0
    assert tr.kernel_s(["k1", "k3"]) == (3.0, 2)
    bd = tr.breakdown()
    assert bd["idle_gaps"] == [["cudaLaunchKernel", 1.0]]
    assert dict(bd["device_ops"]) == {"k1": 2.0, "k2": 2.0, "k3": 1.0}


def test_no_jax_compares_whole_top_level_names():
    assert nojax.forbidden(["multimodal_outage_tpu_torch", "multimodal_outage_tpu_torch.serving",
                            "torch", "jaxtyping", "flaxen"]) == []
    assert nojax.forbidden(["multimodal_outage_tpu"]) == ["multimodal_outage_tpu"]
    assert nojax.forbidden(["multimodal_outage_tpu.ops.x", "jax.numpy", "jaxlib", "flax.linen",
                            "optax", "orbax.checkpoint"]) == sorted(nojax.FORBIDDEN)


def test_a_run_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.');"
            "from outage_bench.tests.tiny import tiny_cell; from outage_bench.run import run_cell;"
            "from outage_bench import nojax;"
            "run_cell(tiny_cell('gwnet.train_b16'), 7, 0.2, True, device='cpu');"
            "print(nojax.loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    assert main(["--workload", "dcrnn.forecast_b1", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
