#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multimodal_outage_tpu_torch) on
one NVIDIA card: builds the hand-written kernels from csrc/, holds each
against its plain PyTorch version at every shape the serving path gives
it, then serves a held-out hurricane end to end at full width through the
CLI's code path and checks that the path went through the kernels.

    python3 chip_smoke.py

Exits non-zero on any failure, and when no CUDA card is present. The last
line of standard output is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is {"kernels": [...]}, one entry per kernel with its
launches on the serving run, error against the plain version, and times.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor / fp32 CUDA-core
M_B1 = 67 * 7  # folded images of one request: 67 counties × 7 days
# (H, Cin, C) of the 9 DoubleConvs of one forward, contraction then expansion
DOUBLE_CONV_SHAPES = (
    (128, 1, 4), (64, 4, 8), (32, 8, 16), (16, 16, 32), (8, 32, 64),
    (16, 64, 32), (32, 32, 16), (64, 16, 8), (128, 8, 4),
)
# float32: kernel and plain version differ only in summation order, so
# atol = rtol = 1e-4. bfloat16: both round at the same points from the
# same inputs, but a different summation order can move a value across a
# bf16 rounding boundary (one ulp = 2^-8 relative) and the flip then
# propagates through later layers (measured on an H100: after the 8
# Graph WaveNet layers at B=16, kernel and plain differ by up to 0.043
# while each is up to 0.049 off float32). So in bf16 the kernel is held to the
# accuracy of the plain version instead: against the same computation in
# float32 (no intermediate rounding), its max error may be at most
# BF16_MAX_RATIO and its RMS error at most BF16_RMS_RATIO times the plain
# version's.
F32_TOL = 1e-4
BF16_MAX_RATIO, BF16_RMS_RATIO = 2.0, 1.25


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` back-to-back calls, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, want, truth=None):
    """(max |got − want|, ok, note). float32 (truth None): elementwise
    within F32_TOL. bfloat16: got's error against the float32 `truth` is
    held to the BF16_*_RATIO multiples of want's error against it."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        return math.inf, False, "shape or non-finite"
    err = float((got - want).abs().max())
    if truth is None:
        ok = torch.allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        return err, bool(ok), ""
    truth = truth.float()
    e_got, e_want = (got - truth).abs(), (want - truth).abs()
    floor = 1e-6 * float(truth.abs().max())
    r_max = float(e_got.max()) / (float(e_want.max()) + floor)
    r_rms = float(e_got.square().mean().sqrt()) / (float(e_want.square().mean().sqrt()) + floor)
    ok = r_max <= BF16_MAX_RATIO and r_rms <= BF16_RMS_RATIO
    return err, ok, f"err vs f32: max ratio {r_max:.3f} rms ratio {r_rms:.3f}, plain max {float(e_want.max()):.4g}"


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def check_double_conv(torch, F, dcm, gen):
    """Phase 3a: the DoubleConv kernel at the 9 shapes of a B=1 forward."""
    rows, failures = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for h, cin, c in DOUBLE_CONV_SHAPES:
            dev = "cuda"
            randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
            x = torch.relu(randn(M_B1, h, h, cin)).to(dtype)
            w1 = (randn(3, 3, cin, c) * (2.0 / (9 * cin)) ** 0.5).to(dtype)
            w2 = (randn(3, 3, c, c) * (2.0 / (9 * c)) ** 0.5).to(dtype)
            s1, s2 = (0.5 + torch.rand(c, generator=gen, device=dev) for _ in range(2))
            b1, b2 = (0.1 * randn(c) for _ in range(2))
            args = (x, w1, s1, b1, w2, s2, b2)
            got = dcm.fused_double_conv(*args)
            want = dcm.double_conv_reference(*args)
            truth = None
            if dtype != torch.float32:
                truth = dcm.double_conv_reference(*(a.float() for a in args))
            torch.cuda.synchronize()
            err, ok, note = compare(got, want, truth)
            # library yardstick: cuDNN conv in the storage dtype + affine + ReLU
            xl = x.permute(0, 3, 1, 2)
            k1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            v = lambda t: t.to(dtype).view(1, -1, 1, 1)

            def library():
                y = torch.relu(F.conv2d(xl, k1, padding=1) * v(s1) + v(b1))
                return torch.relu(F.conv2d(y, k2, padding=1) * v(s2) + v(b2))

            reps = 5 if h >= 64 else 10
            t_k = cuda_ms(lambda: dcm.fused_double_conv(*args), reps)
            t_p = cuda_ms(lambda: dcm.double_conv_reference(*args), reps)
            t_l = cuda_ms(library, reps)
            nbytes = dcm.min_bytes(M_B1, h, h, cin, c, x.element_size())
            nops = dcm.flops(M_B1, h, h, cin, c)
            t_bytes, t_ops = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * nops / PEAK_OPS[dn]
            row = {
                "dtype": dn, "M": M_B1, "H": h, "Cin": cin, "C": c, "max_abs_err": err,
                "ok": ok, "check": note, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                "bytes": nbytes, "flop": nops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            log("double_conv", json.dumps(row))
            rows.append(row)
            if not ok:
                failures.append(f"double_conv {dn} H={h} Cin={cin} C={c}: max err {err}")
    return rows, failures


def check_gwnet_stack(torch, gsm, weights, cfg, gen):
    """Phase 3b: the stack kernel at B=1 and B=16, T=7, N=67."""
    rows, failures = [], []
    var = weights.init_variables(cfg, 7, 67, seed=1)
    st, st_bs = var["params"]["st_gnn"], var["batch_stats"]["st_gnn"]
    # non-trivial running stats so the BN folding is exercised
    for k, bn in st_bs.items():
        bn["mean"] = 0.1 * torch.randn(bn["mean"].shape, generator=torch.Generator().manual_seed(3))
        bn["var"] = 0.5 + torch.rand(bn["var"].shape, generator=torch.Generator().manual_seed(4))
    n_layers = cfg.gwnet.blocks * cfg.gwnet.layers
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        sp = {k: v.cuda() for k, v in gsm.stack_params_from_module(st, st_bs, n_layers, dtype).items()}
        sup = gsm.adaptive_supports(
            torch.eye(67, device="cuda")[None], st["nodevec1"].cuda(), st["nodevec2"].cuda(), dtype
        )
        for b in (1, 16):
            x = torch.randn(b, 67, 7, cfg.st_gnn_in_dim, generator=gen, device="cuda").to(dtype)
            got = gsm.gwnet_stack_forward(x, sup, sp, order=cfg.gwnet.order)
            want = gsm.stack_forward_reference(x, sup, sp, order=cfg.gwnet.order)
            truth = None
            if dtype != torch.float32:
                truth = gsm.stack_forward_reference(
                    x.float(), sup.float(), {k: v.float() for k, v in sp.items()},
                    order=cfg.gwnet.order,
                )
            torch.cuda.synchronize()
            err, ok, note = compare(got, want, truth)
            t_k = cuda_ms(lambda: gsm.gwnet_stack_forward(x, sup, sp, order=cfg.gwnet.order), 20)
            t_p = cuda_ms(lambda: gsm.stack_forward_reference(x, sup, sp, order=cfg.gwnet.order), 5)
            nbytes = gsm.min_bytes(x, sup, sp, sp["e2w"].shape[1])
            nops = gsm.flops(b, 67, 7, sp, sup.shape[0], cfg.gwnet.order)
            t_bytes, t_ops = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * nops / PEAK_OPS[dn]
            row = {
                "dtype": dn, "B": b, "N": 67, "T": 7, "max_abs_err": err, "ok": ok,
                "check": note, "ms": t_k, "plain_ms": t_p, "library_ms": None, "bytes": nbytes,
                "flop": nops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            log("gwnet_stack", json.dumps(row))
            rows.append(row)
            if not ok:
                failures.append(f"gwnet_stack {dn} B={b}: max err {err}")
    return rows, failures


def serve_end_to_end(torch, cli, dcm, gsm, workdir):
    """Phase 4: serve B=1 and B=16 requests at full width through the CLI's
    code path; the launch counters are read around exactly that run."""
    from multimodal_outage_tpu_torch.core.registry import HURRICANES
    from multimodal_outage_tpu_torch.data.synthetic import generate_store

    store_dir = os.path.join(workdir, "store")
    t0 = time.perf_counter()
    # one storm at ±24 days: 34 test windows, two full B=16 batches
    generate_store(store_dir, n_counties=67, image_size=128, margin=24, seed=7,
                   hurricanes={"michael": HURRICANES["michael"]})
    log(f"synth store: {time.perf_counter() - t0:.1f} s")
    common = ["serve", "--data_dir", store_dir, "--case", "michael",
              "--dataset_range", "24", "--seed", "0", "--latency_stats"]
    runs = {}
    dcm.fused_double_conv.launches = 0
    gsm.gwnet_stack_forward.launches = 0
    for b, k in ((1, 3), (16, 3)):
        before = (dcm.fused_double_conv.launches, gsm.gwnet_stack_forward.launches)
        out = cli.run(common + ["--batch_size", str(b), "--max_batches", str(k)])
        torch.cuda.synchronize()
        f = out["forwards"]
        grew = (dcm.fused_double_conv.launches - before[0],
                gsm.gwnet_stack_forward.launches - before[1])
        log(f"serve B={b}: {json.dumps(out)} launches {grew}")
        if grew != (9 * f, f):
            raise RuntimeError(f"serve B={b}: {f} forwards launched {grew}, expected {(9 * f, f)}")
        if not all(math.isfinite(v) for v in out["metrics"].values()):
            raise RuntimeError(f"serve B={b}: non-finite metrics {out['metrics']}")
        runs[b] = out
    launches = {"double_conv": dcm.fused_double_conv.launches,
                "gwnet_stack": gsm.gwnet_stack_forward.launches}
    return store_dir, runs, launches


def engine_vs_plain(torch, store_dir):
    """Phase 4b: one full-width B=16 batch through the kernel engine and
    through the same engine on the plain versions, on the card, in bf16
    and float32."""
    from multimodal_outage_tpu_torch.core.config import (
        DEFAULT_NTL_MEAN,
        DEFAULT_NTL_STD,
        ModelConfig,
    )
    from multimodal_outage_tpu_torch.core.registry import HURRICANES
    from multimodal_outage_tpu_torch.data.adjacency import static_supports
    from multimodal_outage_tpu_torch.data.dataset import WindowDataset
    from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.serving import ServingModel
    from multimodal_outage_tpu_torch.weights import init_variables

    store = load_store(store_dir)
    ds = WindowDataset.from_case_study(store, {"michael": HURRICANES["michael"]}, 24, 7)
    sup = static_supports(67, "identity")
    failures = []
    var = init_variables(ModelConfig(), 7, 67, seed=0)
    engines = {
        (dn, ref): ServingModel(ModelConfig(compute_dtype=dn), var, sup, device="cuda", reference=ref)
        for dn in ("bfloat16", "float32") for ref in (False, True)
    }
    pipe = DevicePipeline(store, DEFAULT_NTL_MEAN, DEFAULT_NTL_STD, 128,
                          torch.bfloat16, torch.device("cuda"))
    batch = pipe.batch(ds, list(range(16)))
    x, feats = batch["x"], batch["date_feats"]
    out = {k: e(x, feats) for k, e in engines.items()}
    torch.cuda.synchronize()
    # the float32 plain engine on the same (bf16-rounded) frames is the
    # accuracy yardstick for the bf16 engines
    for dn, truth in (("bfloat16", out[("float32", True)]), ("float32", None)):
        got, want = out[(dn, False)], out[(dn, True)]
        err, ok, note = compare(got, want, truth)
        ok = ok and tuple(got.shape) == (16, 67, 7, 128, 128, 1)
        log(f"engine vs plain engine {dn} B=16: shape {tuple(got.shape)} max abs err {err} "
            f"output rms {float(want.square().mean().sqrt()):.4g} {note} ok {ok}")
        if not ok:
            failures.append(f"engine {dn}: max err {err} {note}")
    return failures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; it needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from multimodal_outage_tpu_torch import cli, weights
    from multimodal_outage_tpu_torch.core.config import ModelConfig
    from multimodal_outage_tpu_torch.ops import _build
    from multimodal_outage_tpu_torch.ops import double_conv as dcm
    from multimodal_outage_tpu_torch.ops import gwnet_stack as gsm

    t_start = time.perf_counter()
    smi = smi_line()
    log(f"phase 1: {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    for name, (secs, report) in built.items():
        log(f"phase 2: built {name} in {secs:.1f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {line.strip()}")
    log(f"phase 2: build {time.perf_counter() - t0:.1f} s")

    # exact float32 plain references: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dc_rows, f1 = check_double_conv(torch, F, dcm, gen)
    st_rows, f2 = check_gwnet_stack(torch, gsm, weights, ModelConfig(), gen)
    if f1 or f2:
        raise RuntimeError("phase 3: kernel disagrees with its plain version:\n" + "\n".join(f1 + f2))
    log("phase 3: both kernels agree with their plain versions at every shape")

    with tempfile.TemporaryDirectory() as workdir:
        store_dir, runs, launches = serve_end_to_end(torch, cli, dcm, gsm, workdir)
        f3 = engine_vs_plain(torch, store_dir)
    if f3:
        raise RuntimeError("phase 4: engine disagrees with the plain engine:\n" + "\n".join(f3))
    for b, out in runs.items():
        log(f"phase 4: serve B={b} metrics {json.dumps(out['metrics'])} "
            f"p50 {out['latency']['p50_ms']:.3f} ms p90 {out['latency']['p90_ms']:.3f} ms")

    main_dc = [r for r in dc_rows if r["dtype"] == "bfloat16"]
    main_st = [r for r in st_rows if r["dtype"] == "bfloat16" and r["B"] == 1][0]
    dc_bytes = sum(r["bytes"] for r in main_dc) / H100_BYTES_PER_S
    dc_ops = sum(r["flop"] for r in main_dc) / PEAK_OPS["bfloat16"]
    kernels = [
        {
            "name": "double_conv", "route": "cuda",
            "source": "multimodal_outage_tpu_torch/csrc/double_conv.cu",
            "replaces": "multimodal_outage_tpu/ops/unet_pallas.py:119",
            "launches": launches["double_conv"],
            "max_abs_err": max(r["max_abs_err"] for r in main_dc),
            "ms": sum(r["ms"] for r in main_dc),
            "plain_ms": sum(r["plain_ms"] for r in main_dc),
            "bound_ms": 1e3 * max(dc_bytes, dc_ops),
            "bound_by": "bytes" if dc_bytes >= dc_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in main_dc),
        },
        {
            "name": "gwnet_stack", "route": "cuda",
            "source": "multimodal_outage_tpu_torch/csrc/gwnet_stack.cu",
            "replaces": "multimodal_outage_tpu/ops/gwnet_stack_pallas.py:200",
            "launches": launches["gwnet_stack"],
            "max_abs_err": main_st["max_abs_err"], "ms": main_st["ms"],
            "plain_ms": main_st["plain_ms"], "bound_ms": main_st["bound_ms"],
            "bound_by": main_st["bound_by"], "library_ms": None,
        },
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s; kernel times are one B=1 "
        "forward's calls in bf16 (double_conv: the sum of its 9 shapes)")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
