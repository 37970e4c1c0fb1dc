"""The port's benchmark suite (multimodal_outage_tpu_torch/benchmarks.py)
against the JAX package's, on the CPU at 4 counties and 16² frames.

JAX's configs cannot run here at full width, so JAX's metric names and
units are read from its source (the dict literals of each bench_*
function) and its detail keys from the table below, which cites the lines
of multimodal_outage_tpu/benchmarks.py. Detail keys are compared under the
port's renaming of JAX and TPU names (xla/flax → module, mxu → tensor).
"""

import ast
import inspect
import json
import math
import subprocess

import numpy as np
import pytest
import torch

from multimodal_outage_tpu import benchmarks as JB
from multimodal_outage_tpu_torch import benchmarks as B
from multimodal_outage_tpu_torch import cli


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def e2e_store(tmp_path_factory):
    """JAX's e2e store (margin 20, seed 0) at 4 counties and 16²."""
    from multimodal_outage_tpu_torch.data.synthetic import generate_store

    out = str(tmp_path_factory.mktemp("e2e_store"))
    generate_store(out, n_counties=4, image_size=16, margin=20, seed=0)
    return out


@pytest.fixture()
def tiny_e2e(e2e_store, monkeypatch):
    """Both packages' e2e store pointed at the tiny one (JAX's own would
    write 0.5 GB), and the chained composition cut to 2 forwards."""
    monkeypatch.setitem(B._E2E_STORE, "dir", e2e_store)
    monkeypatch.setitem(JB._E2E_STORE, "dir", e2e_store)
    monkeypatch.setattr(B, "_CHAIN_REPS", 2)
    return e2e_store


def _rename(key: str) -> str:
    """A JAX detail key (or bound value) under the port's names."""
    return key.replace("xla", "module").replace("flax", "module").replace("mxu", "tensor")


def _jax_lines():
    """{bench function name: (metric, unit)} from the dict literals in JAX
    benchmarks.py; an f-string unit is kept as its AST node."""
    tree = ast.parse(inspect.getsource(JB))
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or not fn.name.startswith("bench_"):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Dict):
                keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
                if "metric" in keys and "unit" in keys:
                    vals = dict(zip(keys, node.values))
                    unit = vals["unit"]
                    out[fn.name] = (vals["metric"].value,
                                    unit.value if isinstance(unit, ast.Constant) else unit)
    return out


JAX_LINES = _jax_lines()

THROUGHPUT = {"step_seconds", "tiles_per_step", "tiles_per_sec", "batch",
              "image_size"}  # :102-108
ROOF = {"device_kind", "gflops_per_step", "gbytes_per_step", "measured_ms"}  # :1228-1233


def _stack_keys(pair):
    return {f"b{b}_{name}_{what}" for b in (1, 16) for name in pair
            for what in ("ms", "device_us")}


# config: (tiny sizes, JAX detail keys on a CPU, where JAX sets them)
CONFIGS = {
    "e2e_train": (dict(n=4, s=16), {"step_seconds", "tiles_per_step", "batch", "remat",
                                    "oom_batches"}),  # :339-345
    "dcrnn": (dict(n=4, s=16), THROUGHPUT | {"forecast_latency_ms"}),  # :792-795
    "unet_train": (dict(n=4, s=16), THROUGHPUT),  # :119
    "serving": (dict(n=4, s=16), {"flax_eval_ms", "speedup_vs_flax",
                                  "b16_throughput_tiles_per_sec"}),  # :1103-1107
    "fusion_inference": (dict(n=4, s=16), set()),  # :1061
    "unet_cpu_b4": (dict(s=16), THROUGHPUT),  # :887
    "gwnet_forecast": (dict(n=4), {"b1_xla", "b16_xla"}),  # :923-940, XLA only off the TPU
    "gwnet_stack": (dict(n=4), _stack_keys(("xla", "stack"))),  # :995-996, 1027-1028
    "dcrnn_stack": (dict(n=4), _stack_keys(("xla", "stack"))),  # :839-840, 868-869
    "pool_pallas": (dict(s=16, b=2), {"iso_reduce_window", "iso_pallas", "reduce_window",
                                 "pallas"}),  # :654-694
    "remat_conv": (dict(s=16, b=2), {"base", "remat_conv"}),  # :754-760
    "roofline": (dict(s=16), ROOF),  # :1228-1233 (no floor keys without peaks)
    "serving_roofline": (dict(n=4, s=16), ROOF | {"tiles_per_sec"}),  # :1342-1344
    "fused_stack": (dict(s=16), THROUGHPUT),  # :1362
    "multimodal_fusion": (dict(n=4, s=16), THROUGHPUT),  # :1375
    "grad_accum_sync": (dict(s=16, b=4), {"pipelined_tiles_per_sec", "synced_tiles_per_sec",
                                     "pipelined_step_ms", "synced_step_ms"}),  # :1472-1477
    "layout_matrix": (dict(s=16, b=2), {"base", "pool", "stem", "pool_stem", "base2",
                                        "stem8"}),  # :573-587
    "conv_layout": (dict(m=4, s=16), {"nhwc", "nchw", "nchw_xpose"}),  # :1177-1183
}
CONFIGS.update({  # the mesh configs: a group of one gloo rank on the CPU
    "sharded_pipeline": (dict(n=4, s=16), {"devices", "batch"}),  # :1410-1413
    "serving_sharded": (dict(n=4, s=16), {"devices", "batch"}),  # :1526-1529
})
UNPORTED = {"xla_flag_sweep": "XLA", "auto_layout": "XLA"}


def test_config_table_is_jaxs():
    assert list(B._BENCHMARKS) == list(JB._BENCHMARKS)
    assert set(CONFIGS) | {"batch_scaling"} | set(UNPORTED) == set(B._BENCHMARKS)
    assert B.NORTH_STAR_TILES_PER_SEC == JB.NORTH_STAR_TILES_PER_SEC


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_configs_raise_with_their_reason(name):
    with pytest.raises(NotImplementedError, match=UNPORTED[name]):
        B.run_benchmark(name, steps=1, device="cpu")


def test_unknown_name_raises_jaxs_error():
    with pytest.raises(ValueError) as theirs:
        JB.run_benchmark("nope")
    with pytest.raises(ValueError) as ours:
        B.run_benchmark("nope", device="cpu")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_line_matches_jax(name, tiny_e2e):
    sizes, jax_detail = CONFIGS[name]
    out = B.run_benchmark(name, steps=1, device="cpu", **sizes)
    assert list(out) == ["metric", "value", "unit", "vs_baseline", "detail"]
    metric, unit = JAX_LINES[JB._BENCHMARKS[name].__name__]
    if isinstance(unit, ast.JoinedStr):  # JAX's f-string, at the port's values
        detail = out["detail"]
        numeric = {k: v for k, v in detail.items() if isinstance(v, float)}
        # JAX's best: the fastest variant (least ms for conv_layout)
        best = (min if name == "conv_layout" else max)(numeric, key=numeric.get, default=None)
        names = {"n_dev": detail.get("devices"), "b": detail.get("batch"), "best": best}
        unit = "".join(str(v.value) if isinstance(v, ast.Constant) else str(names[v.value.id])
                       for v in unit.values)
    assert (out["metric"], out["unit"]) == (metric, unit)
    assert set(out["detail"]) == {_rename(k) for k in jax_detail}
    assert out["value"] is not None
    json.loads(json.dumps(out))  # what the CLI prints


def test_batch_scaling_line_matches_jax(tiny_e2e, monkeypatch):
    """The grid's keys, "oom" cells and best cell as JAX's, with both
    packages' cells patched alike (cells do not run here)."""
    def cell(pkg):
        def fake(b, steps, remat, **kw):
            if b >= 16 and not (remat and b == 16):
                raise pkg.BenchOOM("oom")
            return 0.01 * b * (1.5 if remat else 1.0)
        return fake

    monkeypatch.setattr(B, "_e2e_cell_subprocess", cell(B))
    monkeypatch.setattr(JB, "_e2e_cell_subprocess", cell(JB))
    monkeypatch.setattr("time.sleep", lambda s: None)  # JAX's settle sleeps
    theirs, ours = JB.bench_batch_scaling(steps=1), B.bench_batch_scaling(steps=1, device="cpu")
    assert ours == theirs
    assert ours["detail"]["b32"] == "oom" and ours["unit"] == "tiles/sec/chip (best b4)"
    assert isinstance(JAX_LINES["bench_batch_scaling"][1], ast.JoinedStr)


@pytest.mark.parametrize("ooms_below", [8, 1])
def test_e2e_train_halving_matches_jax(tiny_e2e, monkeypatch, ooms_below):
    """OOM at b=8 → b=4 in a subprocess cell, as JAX; when every batch runs
    out of memory, b=1 re-raises in both."""
    calls = {B: [], JB: []}

    def patch(pkg):
        def fake(b, steps, remat=False, **kw):
            calls[pkg].append(b)
            if b >= 8 or ooms_below == 1:
                raise pkg.BenchOOM("oom")
            return 0.5
        monkeypatch.setattr(pkg, "_e2e_train_seconds", fake)
        monkeypatch.setattr(pkg, "_e2e_cell_subprocess", lambda b, steps, remat, **kw:
                            fake(b, steps, remat))

    patch(B)
    patch(JB)
    if ooms_below == 1:
        with pytest.raises(JB.BenchOOM):
            JB.bench_e2e_train(steps=1)
        with pytest.raises(B.BenchOOM):
            B.bench_e2e_train(steps=1, device="cpu")
    else:
        assert B.bench_e2e_train(steps=1, device="cpu") == JB.bench_e2e_train(steps=1)
    assert calls[B] == calls[JB]


@pytest.mark.parametrize("case", ["sec", "oom", "failed", "timeout"])
def test_cell_subprocess_classifies_the_child(tiny_e2e, monkeypatch, case):
    seen = {}

    def fake_run(cmd, **kw):
        seen.update(cmd=cmd, kw=kw)
        if case == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw["timeout"])
        out = {"sec": "loading\nSEC 0.25\n",
               "oom": "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate",
               "failed": "Traceback ...\nValueError: something else"}[case]
        return subprocess.CompletedProcess(cmd, 1, stdout=out)

    monkeypatch.setattr(subprocess, "run", fake_run)
    call = lambda: B._e2e_cell_subprocess(8, 3, False, timeout_s=7, device="cpu", s=16)  # noqa: E731
    if case == "sec":
        assert call() == 0.25
    else:
        with pytest.raises(B.BenchOOM if case == "oom" else RuntimeError,
                           match={"oom": "b=8", "failed": "something else",
                                  "timeout": "7 s"}[case]):
            call()
    code = seen["cmd"][-1]
    assert f"B._E2E_STORE['dir'] = {tiny_e2e!r}" in code and "multimodal_outage_tpu_torch" in code
    assert "multimodal_outage_tpu " not in code and seen["kw"]["timeout"] == 7


def test_e2e_batches_are_jaxs(tiny_e2e):
    """Steps 0-2 of the port's e2e loop feed JAX's DevicePipeline batches
    of windows (arange(b) + i) % (n_samples − b) on the same store."""
    from multimodal_outage_tpu.core.registry import HURRICANES
    from multimodal_outage_tpu.data.dataset import WindowDataset
    from multimodal_outage_tpu.data.pipeline import DevicePipeline
    from multimodal_outage_tpu.data.store import load_store

    store = load_store(tiny_e2e)
    jds = WindowDataset.from_case_study(store, HURRICANES, dataset_range=15, horizon=7)
    jpipe = DevicePipeline(store, 3.2, 10.4, 16)
    _, ds, pipe = B._e2e_data(torch.device("cpu"), s=16)
    su = {"pipe": pipe, "ds": ds, "n_samples": len(ds)}
    assert len(ds) == len(jds) > 8
    b = 4
    for i in range(3):
        want = jpipe.batch(jds, (np.arange(b) + i) % (len(jds) - b))
        got = B._e2e_batch(su, b, i)
        assert got["x"].dtype == torch.bfloat16
        for k in ("x", "y", "date_feats"):
            np.testing.assert_allclose(got[k].float().numpy(),
                                       np.asarray(want[k], np.float32), rtol=1e-6, atol=1e-6)


def test_roofline_report_is_jaxs(monkeypatch):
    """Same floor, bound and fraction for the same inputs with peaks
    patched in both; an unknown device gives NaN and no floor keys."""
    peaks = ("fake card", (200e12, 800e9))
    monkeypatch.setattr(JB, "_device_peaks", lambda: peaks)
    monkeypatch.setattr(B, "_device_peaks", lambda device=None: peaks)
    for flops, byts, sec in ((100e9, 80e9, 0.2), (500e12, 8e9, 4.0)):
        jd, jf = JB._roofline_report(flops, byts, sec)
        d, f = B._roofline_report(flops, byts, sec)
        assert d == {_rename(k): _rename(v) if k == "bound" else v for k, v in jd.items()}
        assert f == jf
    monkeypatch.setattr(JB, "_device_peaks", lambda: ("mystery", (None, None)))
    monkeypatch.setattr(B, "_device_peaks", lambda device=None: ("mystery", (None, None)))
    (d, f), (jd, jf) = B._roofline_report(1e9, 1e9, 0.1), JB._roofline_report(1e9, 1e9, 0.1)
    assert math.isnan(f) and math.isnan(jf) and d == jd and "bound" not in d


def test_device_peaks():
    assert B._device_peaks("cpu") == ("cpu", (None, None))
    assert B._PEAKS["h100 80gb hbm3"] == (989e12, 3.35e12)


def test_step_cost_counts_by_hand():
    x = torch.randn(2, 3, 8, 8)
    w = torch.randn(4, 3, 3, 3)
    a, m = torch.randn(5, 6), torch.randn(6, 7)
    out = {}

    def fn():
        out["y"] = torch.nn.functional.conv2d(x, w, padding=1)
        out["z"] = a @ m
        return out["z"]

    fn()
    flops, byts = B._step_cost(fn, [x, w, a, m], [out["y"], out["z"]])
    # a multiply-add per (output value, input channel, tap), and per (row, col, k)
    assert flops == 2 * (2 * 4 * 8 * 8) * (3 * 3 * 3) + 2 * 5 * 6 * 7
    assert byts == 4 * (x.numel() + w.numel() + a.numel() + m.numel()
                        + out["y"].numel() + out["z"].numel())


def test_train_traffic_is_the_compulsory_count(tiny_e2e):
    su = B.make_e2e_setup(2, device="cpu", s=16)
    reads, writes = B._train_traffic(su, su["batch0"])
    model = su["model"]
    trained = sum(p.numel() for p in model.parameters() if p.requires_grad)
    frozen = sum(p.numel() for p in model.parameters() if not p.requires_grad)
    stats = sum(v.numel() for v in model.buffers())
    assert frozen > 0 and stats > 0  # Date2Vec is frozen; BatchNorm keeps running stats
    batch = sum(v.numel() * v.element_size() for v in su["batch0"].values())
    # params (trained + frozen), gradients, both moments and stats read;
    # trained params, both moments and stats written, all float32
    assert B._nbytes(reads) == batch + su["supports"].numel() * 4 + 4 * (
        trained + frozen + trained + 2 * trained + stats)
    assert B._nbytes(writes) == 4 * (3 * trained + stats)


@pytest.mark.parametrize("which", ["gwnet_stack", "dcrnn_stack"])
def test_stack_pairs_compute_the_same_forecast(which):
    """The A/B pairs of bench gwnet_stack / dcrnn_stack are one function:
    on the CPU the stack's plain version against the module, float32."""
    make = {"gwnet_stack": B.gwnet_stack_fns, "dcrnn_stack": B.dcrnn_stack_fns}[which]
    fns, x, c_in, cores = make(2, 4, device="cpu")
    want, got = fns["module"](), fns["stack"]()
    assert got.shape == want.shape and got.shape[:2] == x.shape[:2]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    chain = B._chained(cores["stack"], x, c_in, torch.device("cpu"), reps=2)()
    assert chain.shape == x.shape


class _Captured(Exception):
    pass


def test_conv_layout_variants_give_jaxs_stem_gradient(monkeypatch):
    """Each layout of conv_layout_fns gives the w1 and w2 gradients that
    JAX bench_conv_layout's jitted variants give, on the same float32
    inputs: JAX's random draws are replaced by seeded numpy arrays at
    [3, 16, 16, 1] and its timing loop by a stop that hands over its
    three variants. Tolerance 1e-4 of each gradient's largest entry: both
    sides sum the same float32 products (3·16² positions a tap) in
    another order, oneDNN's against XLA's convolutions (3e-7 of the
    largest entry measured on the CPU); TF32 is off (it does not act on the CPU, and on the
    card it would round the float32 inputs)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    draws = {(3752, 128, 128, 1): rng.normal(size=(3, 16, 16, 1)),
             (3, 3, 1, 4): rng.normal(size=(3, 3, 1, 4)),
             (3, 3, 4, 4): rng.normal(size=(3, 3, 4, 4))}
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None:
                        jnp.asarray(draws[tuple(shape)], jnp.float32))

    def stop(fns, steps):
        raise _Captured(fns)

    monkeypatch.setattr(JB, "_interleaved_ab", stop)
    with pytest.raises(_Captured) as e:
        JB.bench_conv_layout(steps=1)
    cells = {}
    for fn in e.value.args[0].values():  # the variants' closures: jitted grads, inputs
        cells.update(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))
    x, k1, k2 = cells["x_nhwc"], cells["k1"], cells["k2"]
    want = {"nhwc": cells["g_nhwc"](x, k1, k2), "nchw": cells["g_nchw"](cells["x_nchw"], k1, k2),
            "nchw_xpose": cells["g_xpose"](x, k1, k2)}
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    fns = B.conv_layout_fns(*(torch.from_numpy(np.array(a)) for a in (x, k1, k2)))
    assert list(fns) == list(want)
    for name, fn in fns.items():
        got = fn()
        assert len(got) == 2
        for g, w in zip(got, want[name]):
            w = torch.from_numpy(np.array(w))
            assert g.shape == w.shape and g.dtype == torch.float32
            bar = 1e-4 * float(w.abs().max())
            torch.testing.assert_close(g, w, rtol=0, atol=bar)


@pytest.mark.parametrize("error", ["oom", "other"])
def test_layout_matrix_stem8_failure(tiny_e2e, monkeypatch, error):
    """An out-of-memory error inside stem8's pair is reported as JAX
    reports it, "failed: <ExceptionName>", beside the four variants; any
    other error is a fault of the port and raises."""
    exc = (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.00 GiB")
           if error == "oom" else ValueError("a fault in the stem8 step"))
    real = B._e2e_run

    def run(su, b, pad_c=0):
        if not pad_c:
            return real(su, b, pad_c)

        def fail():
            raise exc
        return fail

    monkeypatch.setattr(B, "_e2e_run", run)
    if error == "other":
        with pytest.raises(ValueError, match="stem8"):
            B.run_benchmark("layout_matrix", steps=1, device="cpu", s=16, b=2)
        return
    out = B.run_benchmark("layout_matrix", steps=1, device="cpu", s=16, b=2)
    d = out["detail"]
    assert d["stem8"] == "failed: OutOfMemoryError" and "base2" not in d
    assert set(d) == {"base", "pool", "stem", "pool_stem", "stem8"}
    best = max((k for k in d if k != "stem8"), key=d.get)
    assert out["value"] == d[best] and out["unit"] == (
        f"tiles/sec/chip (best {best}, interleaved, donate=False)")
    assert out["vs_baseline"] == round(d[best] / d["base"], 3)


def test_bench_cli_parses_jax_defaults_and_prints_the_line(monkeypatch, capsys):
    """`bench --device cpu --config unet_train --steps 1` at a tiny size:
    JAX's defaults, and a last line that bench.py's parser accepts."""
    import functools

    ns = cli._parser().parse_args(["bench"])
    assert (ns.config, ns.steps, ns.device) == ("unet_train", 20, None)
    monkeypatch.setitem(B._BENCHMARKS, "unet_train",
                        functools.partial(B.bench_unet_train, n=2, s=16))
    assert cli.main(["bench", "--device", "cpu", "--config", "unet_train", "--steps", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])  # bench.py:57-65 reads the last JSON line with "metric"
    assert set(result) >= {"metric", "value", "unit", "vs_baseline"}
    assert result["metric"] == "unet_train_tiles_per_sec_per_chip"
    assert result["detail"]["batch"] == 4 and result["detail"]["image_size"] == 16


def test_bench_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the check is for one without")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["bench", "--config", "serving"])

