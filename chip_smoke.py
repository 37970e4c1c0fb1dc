#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multimodal_outage_tpu_torch) on
one NVIDIA card: builds the hand-written kernels from csrc/, holds each
against its plain PyTorch version at every shape the serving and training
paths give it, serves a held-out hurricane end to end at full width
through the CLI's code path, trains one epoch at full width through the
CLI's code path, and checks that each path went through its kernels.

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
# images of one full-width B=8 train step (8 windows × 67 counties × 7
# days) and the (H, C) of its four 2×2 max-pools
M_B8 = 8 * 67 * 7
POOL_SHAPES = ((128, 4), (64, 8), (32, 16), (16, 32))
# phase 5 store: all three storms at ±16 days; --dataset_range 16 gives
# 35 train windows (5 steps at B=8), 15 val and 18 test windows
TRAIN_MARGIN = 16
# phase 5b: a B=8 step with the pool kernels against the same step with
# the plain pool, in float32 with deterministic cuDNN and no TF32: loss,
# BN running stats and each gradient leaf within STEP_RTOL of the plain
# step's, relative to the leaf's largest entry (or 1e-3 of the largest
# gradient of all, for leaves whose true gradient is 0 and whose entries
# are summation noise)
STEP_RTOL = 1e-5


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


def check_max_pool(torch, F, mp, gen):
    """Phase 3c: the max-pool kernel pair at the four pool shapes of a
    full-width B=8 train step, bf16 and float32. Kernel and plain version
    only copy values, so they must agree exactly."""
    rows, failures = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for h, c in POOL_SHAPES:
            x = torch.relu(torch.randn(M_B8, h, h, c, generator=gen, device="cuda")).to(dtype)
            g = torch.randn(M_B8, h // 2, h // 2, c, generator=gen, device="cuda").to(dtype)
            y, dx = mp.max_pool_forward(x), mp.max_pool_backward(x, g)
            y_ref, dx_ref = mp.max_pool_reference(x), mp.max_pool_backward_reference(x, g)
            torch.cuda.synchronize()
            err_f = float((y.float() - y_ref.float()).abs().max())
            err_b = float((dx.float() - dx_ref.float()).abs().max())
            # library yardstick: cuDNN/ATen max-pool on the channels-last
            # view and its indices backward (ties route differently: its
            # values are not compared, only its time)
            xl, gl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            _, idx = F.max_pool2d(xl, 2, return_indices=True)
            lib_bwd = lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                gl, xl, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)
            for name, err, kern, plain, lib, back in (
                ("max_pool_fwd", err_f, lambda: mp.max_pool_forward(x),
                 lambda: mp.max_pool_reference(x), lambda: F.max_pool2d(xl, 2), False),
                ("max_pool_bwd", err_b, lambda: mp.max_pool_backward(x, g),
                 lambda: mp.max_pool_backward_reference(x, g), lib_bwd, True),
            ):
                nbytes = mp.min_bytes(x.numel(), x.element_size(), back)
                nops = mp.ops(x.numel(), back)
                t_bytes = 1e3 * nbytes / H100_BYTES_PER_S
                t_ops = 1e3 * nops / PEAK_OPS["float32"]
                row = {
                    "kernel": name, "dtype": dn, "M": M_B8, "H": h, "C": c,
                    "max_abs_err": err, "ok": err == 0.0, "ms": cuda_ms(kern, 20),
                    "plain_ms": cuda_ms(plain, 5), "library_ms": cuda_ms(lib, 20),
                    "bytes": nbytes, "ops": nops, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                }
                log("max_pool", json.dumps(row))
                rows.append(row)
                if err != 0.0:
                    failures.append(f"{name} {dn} H={h} C={c}: max err {err}")
            del x, g, y, dx, y_ref, dx_ref, idx
    return rows, failures


def train_end_to_end(torch, cli, mp, workdir):
    """Phase 5: one epoch of `train --pool pallas` at full width (bf16,
    B=8) through the CLI's code path, with the launch counters read
    around exactly that run."""
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
    from multimodal_outage_tpu_torch.core.config import ModelConfig
    from multimodal_outage_tpu_torch.data.synthetic import generate_store

    store_dir = os.path.join(workdir, "train_store")
    t0 = time.perf_counter()
    generate_store(store_dir, n_counties=67, image_size=128, margin=TRAIN_MARGIN, seed=11)
    log(f"synth train store: {time.perf_counter() - t0:.1f} s")
    cwd = os.getcwd()
    os.chdir(workdir)  # the run directory is ./logs/<job_id>
    try:
        torch.cuda.reset_peak_memory_stats()
        mp.max_pool_forward.launches = 0
        mp.max_pool_backward.launches = 0
        out = cli.run(["train", "--data_dir", store_dir, "--case", "michael",
                       "--dataset_range", str(TRAIN_MARGIN), "--epochs", "1",
                       "--batch_size", "8", "--seed", "0", "--pool", "pallas",
                       "--job_id", "smoke"])
        torch.cuda.synchronize()
        launches = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(cwd)
    log(f"phase 5: train {json.dumps(out)}")
    steps, evals = out["train_steps"], out["eval_forwards"]
    want = (4 * steps + 4 * evals, 4 * steps)
    log(f"phase 5: {steps} train steps, {evals} eval forwards: pool launches "
        f"(fwd, bwd) {launches}, expected {want}")
    if steps < 2 or launches != want:
        raise RuntimeError(f"phase 5: pool launches {launches}, expected {want}")
    finals = [v for k, v in out.items() if k.startswith(("val_", "test_"))]
    if len(finals) != 8 or not all(math.isfinite(v) for v in finals):
        raise RuntimeError(f"phase 5: non-finite or missing final metrics {out}")
    tree = CheckpointManager(os.path.join(workdir, "logs", "smoke", "checkpoints")).restore()
    init = weights.flatten(weights.init_variables(ModelConfig(pool="pallas"), 7, 67, seed=0)["params"])
    moved = sum(not torch.equal(v, init[k]) for k, v in weights.flatten(tree["params"]).items())
    if tree["step"] != steps or moved < 0.9 * len(init):
        raise RuntimeError(f"phase 5: checkpoint step {tree['step']} of {steps}, "
                           f"{moved} of {len(init)} parameter leaves moved")
    log(f"phase 5: checkpoint restored: step {tree['step']}, {moved} of {len(init)} "
        f"parameter leaves moved from their init (the rest take no gradient)")
    log(f"phase 5: train step p50 {out['train_step_ms_p50']:.3f} ms (CUDA events, "
        f"B=8 bf16, after the first step); peak memory {peak / 2**30:.2f} GiB")
    return store_dir, out, launches, peak


def step_vs_plain(torch, store_dir):
    """Phase 5b: one full-width B=8 train step with the pool kernels
    against the same step with the plain pool, on the card."""
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import (
        DEFAULT_NTL_MEAN,
        DEFAULT_NTL_STD,
        ModelConfig,
    )
    from multimodal_outage_tpu_torch.core.registry import HURRICANES
    from multimodal_outage_tpu_torch.data.dataset import WindowDataset
    from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import make_train_step

    store = load_store(store_dir)
    cases = {k: HURRICANES[k] for k in ("ian", "idalia")}
    ds = WindowDataset.from_case_study(store, cases, TRAIN_MARGIN, 7)
    pipe = DevicePipeline(store, DEFAULT_NTL_MEAN, DEFAULT_NTL_STD, 128,
                          torch.bfloat16, torch.device("cuda"))
    batch = pipe.batch(ds, list(range(8)))
    sup = torch.eye(67, device="cuda")[None]
    var = weights.init_variables(ModelConfig(), 7, 67, seed=3)

    def one_step(dtype: str, plain: bool):
        cfg = ModelConfig(compute_dtype=dtype, pool="pallas")
        model = weights.load_variables(build_model(cfg, 7, 67, 128, pool_reference=plain), var)
        model.cuda()
        m = make_train_step(model)(create_train_state(model), batch, sup, 1e-3, 0)
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).float().cpu()
                 for k, p in model.named_parameters()}
        stats = {k: b.float().cpu() for k, b in model.named_buffers()}
        return float(m["loss"]), grads, stats

    torch.backends.cudnn.deterministic = True
    failures = []
    try:
        runs = {(dt, plain): one_step(dt, plain)
                for dt in ("float32", "bfloat16") for plain in (False, True)}
    finally:
        torch.backends.cudnn.deterministic = False
    (lk, gk, sk), (lp, gp, sp) = runs[("float32", False)], runs[("float32", True)]
    g_all = max(float(v.abs().max()) for v in gp.values())
    worst_g = max(float((gk[k] - gp[k]).abs().max()) / max(float(gp[k].abs().max()), 1e-3 * g_all)
                  for k in gp)
    worst_s = max(float(((sk[k] - sp[k]).abs() / sp[k].abs().clamp(min=1e-6)).max()) for k in sp)
    ok = abs(lk - lp) <= STEP_RTOL * abs(lp) and worst_g <= STEP_RTOL and worst_s <= STEP_RTOL
    log(f"phase 5b: float32 B=8 step, kernels vs plain pool: loss {lk!r} vs {lp!r}, "
        f"worst grad leaf rel {worst_g:.3g}, worst BN stat rel {worst_s:.3g}, ok {ok}")
    if not ok:
        failures.append("float32 step")
    # bf16: held to the plain bf16 step's own error against the f32 plain step
    (lb, gb, _), (lpb, gpb, _) = runs[("bfloat16", False)], runs[("bfloat16", True)]
    tens = lambda v: torch.tensor([v])
    _, ok_l, note_l = compare(tens(lb), tens(lpb), tens(lp))
    # leaves with no gradient at all (the frozen Date2Vec, the last Graph
    # WaveNet layer's residual branch) must stay exactly zero
    live = [k for k in gpb if gp[k].abs().max() > 0]
    bad = [k for k in gpb if k not in live and gb[k].abs().max() > 0]
    bad += [k for k in live if not compare(gb[k], gpb[k], gp[k])[1]]
    log(f"phase 5b: bfloat16 B=8 step: loss {lb!r} (plain {lpb!r}, float32 {lp!r}) {note_l}; "
        f"{len(gpb) - len(bad)} of {len(gpb)} grad leaves within the ratio bar")
    if not ok_l or bad:
        failures.append(f"bfloat16 step: loss ok {ok_l}, leaves off {bad[:5]}")
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
    from multimodal_outage_tpu_torch.ops import max_pool as mp

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
    mp_rows, f3 = check_max_pool(torch, F, mp, gen)
    if f1 or f2 or f3:
        raise RuntimeError("phase 3: kernel disagrees with its plain version:\n"
                           + "\n".join(f1 + f2 + f3))
    log("phase 3: every kernel agrees with its plain version at every shape")

    with tempfile.TemporaryDirectory() as workdir:
        store_dir, runs, launches = serve_end_to_end(torch, cli, dcm, gsm, workdir)
        f4 = engine_vs_plain(torch, store_dir)
        if f4:
            raise RuntimeError("phase 4: engine disagrees with the plain engine:\n" + "\n".join(f4))
        for b, out in runs.items():
            log(f"phase 4: serve B={b} metrics {json.dumps(out['metrics'])} "
                f"p50 {out['latency']['p50_ms']:.3f} ms p90 {out['latency']['p90_ms']:.3f} ms")
        train_store, _, pool_launches, _ = train_end_to_end(torch, cli, mp, workdir)
        f5 = step_vs_plain(torch, train_store)
        if f5:
            raise RuntimeError("phase 5b: kernel step disagrees with the plain step:\n"
                               + "\n".join(f5))

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
    for i, name in enumerate(("max_pool_fwd", "max_pool_bwd")):
        rows = [r for r in mp_rows if r["kernel"] == name and r["dtype"] == "bfloat16"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "multimodal_outage_tpu_torch/csrc/max_pool.cu",
            "replaces": "multimodal_outage_tpu/ops/pool_pallas.py:" + ("163", "191")[i],
            "launches": pool_launches[i],
            "max_abs_err": max(r["max_abs_err"] for r in mp_rows if r["kernel"] == name),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes",
            "library_ms": sum(r["library_ms"] for r in rows),
        })
    log(f"total {time.perf_counter() - t_start:.1f} s; kernel times are bf16: one B=1 "
        "serving forward's calls (double_conv: the sum of its 9 shapes) and one B=8 "
        "train step's pools (max_pool: the sum of its 4 shapes)")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
