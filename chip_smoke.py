#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multimodal_outage_tpu_torch) on
one NVIDIA card: builds the hand-written kernels from csrc/, holds each
against its plain PyTorch version at every shape the serving and training
paths give it, serves a held-out hurricane end to end at full width
through the CLI's code path with Graph WaveNet and with DCRNN, trains one
epoch at full width through the CLI's code path and one through `fit`
with the per-layer Graph WaveNet kernel, reads the trained checkpoint
back through `evaluate` and `serve --checkpoint_path` (and a DCRNN
checkpoint through `serve`), trains DCRNN with scheduled sampling for an
epoch and reads that checkpoint back the same two ways, runs the run
options (phase 9: `train --resume --tensorboard --profile_dir`, a
float32 resumed run against the straight one, `pretrain-d2v` and `train
--d2v_bundle`, and `serve` with `--adjtype doubletransition` (3
supports), `--no_addaptadj` (1) and `--adjacency`, with kernels 2 and 3
held to their plain versions at those supports), trains, evaluates and
serves the non-fused Graph WaveNet (phase 10: `--gwnet_kernel_size 2
--svd_aptinit`, engines for `--no_gcn` and kernel_size 2 against plain,
and reference_view_quirk through kernel 3), and checks that each path
went through its kernels.

    python3 chip_smoke.py

Exits non-zero on any failure, and when no CUDA card is present. The last
line of standard output is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is {"kernels": [...]}, one entry per kernel with its
launches on the run of its path, error against the plain version, and
times. Imports nothing of JAX.
"""

from __future__ import annotations

import glob
import importlib
import json
import math
import os
import shutil
import sys
import tempfile
import time

# CUDA timing helpers shared with the kernel timing tools
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
from _timing import card, device_ms, events_ms, events_ms_cold, flush_buffer  # noqa: E402

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
# phase 3d: batch sizes of the per-layer Graph WaveNet kernel: a B=1
# request, a B=8 train step, a B=16 request
LAYER_BATCHES = (1, 8, 16)
# phase 7: evaluate of phase 5's checkpoint runs the code of fit's final
# test sweep over the same batches in the same process, so its metrics
# should equal phase 5's; serve (BN folded, bf16 engine) is held to the
# module's metrics as the JAX package's dress rehearsal holds them (MAPE
# left out: near-zero targets amplify any difference)
METRICS = ("loss", "mae", "mape", "rmse")
EVAL_RTOL, SERVE_RTOL = 1e-6, 1e-2
# phase 8a: the DCRNN teacher-forcing step with the pool kernels against
# the same step with the plain pool, float32 (the bar of the port's
# float32 kernels on the card)
DCRNN_STEP_RTOL = 1e-4
# phase 9a: a float32 run resumed after its first epoch against the same
# run straight through, with deterministic cuDNN and no TF32: the same
# steps on the same restored tensors, so any gap is a resume fault
RESUME_RTOL = 1e-6


def log(*a):
    print(*a, flush=True)


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
            t_k = events_ms(lambda: dcm.fused_double_conv(*args), reps)
            t_p = events_ms(lambda: dcm.double_conv_reference(*args), reps)
            t_l = events_ms(library, reps)
            nbytes = dcm.min_bytes(M_B1, h, h, cin, c, x.element_size())
            nops = dcm.flops(M_B1, h, h, cin, c)
            t_bytes, t_ops = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * nops / PEAK_OPS[dn]
            _, _, smem, blocks = dcm.launch_config(M_B1, h, h, cin, c, dtype, x.device)
            row = {
                "dtype": dn, "M": M_B1, "H": h, "Cin": cin, "C": c, "max_abs_err": err,
                "ok": ok, "check": note, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                "vs_library": t_k / t_l, "smem_bytes": smem, "blocks": blocks,
                "bytes": nbytes, "flop": nops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            log("double_conv", json.dumps(row))
            rows.append(row)
            if not ok:
                failures.append(f"double_conv {dn} H={h} Cin={cin} C={c}: max err {err}")
    slow = [f"{r['H']}² {r['Cin']}→{r['C']} ({r['vs_library']:.2f}×)"
            for r in rows if r["dtype"] == "bfloat16" and r["vs_library"] > 1]
    log(f"phase 3a: bf16 shapes where the kernel is slower than cuDNN: {', '.join(slow) or 'none'}")
    return rows, failures


def check_gwnet_stack(torch, gsm, weights, cfg, gen, static=None, label="3b"):
    """Phase 3b: the stack kernel at B=1 and B=16, T=7, N=67: the bf16
    body (tensor cores, weights in fragment order) and the float32 body
    (CUDA cores), each with its shared-memory bytes per block. The
    supports are `static` ([S, 67, 67] on the card; the identity by
    default) and the adaptive one when cfg.gwnet.addaptadj (phase 9c: S =
    1 and 3)."""
    rows, failures = [], []
    if static is None:
        static = torch.eye(67, device="cuda")[None]
    var = weights.init_variables(cfg, 7, 67, seed=1)
    st, st_bs = var["params"]["st_gnn"], var["batch_stats"]["st_gnn"]
    # non-trivial running stats so the BN folding is exercised
    for k, bn in st_bs.items():
        bn["mean"] = 0.1 * torch.randn(bn["mean"].shape, generator=torch.Generator().manual_seed(3))
        bn["var"] = 0.5 + torch.rand(bn["var"].shape, generator=torch.Generator().manual_seed(4))
    g = cfg.gwnet
    n_layers = g.blocks * g.layers
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        sp = {k: v.cuda() for k, v in gsm.stack_params_from_module(st, st_bs, n_layers, dtype).items()}
        if dtype == torch.bfloat16:
            sp["frags"] = gsm.stack_fragments(sp)
        node = [st[k].cuda() if k in st else None for k in ("nodevec1", "nodevec2")]
        sup = gsm.adaptive_supports(static, *node, dtype)
        smem = gsm.smem_bytes(67, cfg.st_gnn_in_dim, g.residual_channels, g.dilation_channels,
                              g.skip_channels, g.end_channels, cfg.feature_vector_size,
                              sup.shape[0], g.order, dtype)
        log(f"phase {label}: {dn} body, {smem} bytes of shared memory per block at N=67, "
            f"S={sup.shape[0]}")
        for b in (1, 16):
            x = torch.randn(b, 67, 7, cfg.st_gnn_in_dim, generator=gen, device="cuda").to(dtype)
            got = gsm.gwnet_stack_forward(x, sup, sp, order=cfg.gwnet.order)
            want = gsm.stack_forward_reference(x, sup, sp, order=cfg.gwnet.order)
            truth = None
            if dtype != torch.float32:
                truth = gsm.stack_forward_reference(
                    x.float(), sup.float(), {k: v.float() for k, v in sp.items() if k != "frags"},
                    order=cfg.gwnet.order,
                )
            torch.cuda.synchronize()
            err, ok, note = compare(got, want, truth)
            t_k = events_ms(lambda: gsm.gwnet_stack_forward(x, sup, sp, order=cfg.gwnet.order), 20)
            t_p = events_ms(lambda: gsm.stack_forward_reference(x, sup, sp, order=cfg.gwnet.order), 5)
            nbytes = gsm.min_bytes(x, sup, sp, sp["e2w"].shape[1])
            nops = gsm.flops(b, 67, 7, sp, sup.shape[0], cfg.gwnet.order)
            t_bytes, t_ops = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * nops / PEAK_OPS[dn]
            row = {
                "dtype": dn, "B": b, "N": 67, "T": 7, "S": sup.shape[0], "max_abs_err": err,
                "ok": ok,
                "check": note, "ms": t_k, "plain_ms": t_p, "library_ms": None, "bytes": nbytes,
                "flop": nops, "smem_bytes": smem, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            log("gwnet_stack", json.dumps(row))
            rows.append(row)
            if not ok:
                failures.append(f"gwnet_stack {dn} B={b} S={sup.shape[0]}: max err {err}")
    return rows, failures


def bound(nbytes: int, nops: int, dtype_name: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of the dtype."""
    t_bytes, t_ops = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * nops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_gwnet_layer(torch, glm, gsm, weights, cfg, gen):
    """Phase 3d: the per-layer Graph WaveNet kernel at B = 1, 8, 16, T=7,
    N=67, C=Cd=32, Cs=256, order 2, S=2 (identity + the softmax adaptive
    adjacency), bf16 (the tensor-core body) and float32: CUDA events per
    call back to back (ms) and with the L2 flushed before each call
    (cold_ms), both of which include the host's enqueue, and the kernel's
    device time from torch.profiler, back to back (device_ms) and with the
    L2 flushed (device_cold_ms); and at B=8 in float32 the gradients
    through fused_gwnet_layer (supports included) against autograd of the
    plain version."""
    rows, failures = [], []
    flush = flush_buffer()
    st = weights.init_variables(cfg, 7, 67, seed=1)["params"]["st_gnn"]
    names = [f"{k}0_{p}" for k in ("filter_conv", "gate_conv", "skip_conv", "gconv")
             for p in ("kernel", "bias")]
    order = cfg.gwnet.order
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        w = [st[k].to("cuda", dtype).contiguous() for k in names]
        sup = gsm.adaptive_supports(torch.eye(67, device="cuda")[None], st["nodevec1"].cuda(),
                                    st["nodevec2"].cuda(), dtype)
        for b in LAYER_BATCHES:
            x = torch.randn(b, 67, 7, 32, generator=gen, device="cuda").to(dtype)
            args = (x, sup, *w)
            got = glm.gwnet_layer_forward(*args, order=order)
            want = glm.gwnet_layer_reference(*args, order=order)
            truth = (None,) * 2
            if dtype != torch.float32:
                truth = glm.gwnet_layer_reference(*(a.float() for a in args), order=order)
            torch.cuda.synchronize()
            checks = [compare(g, wt, tr) for g, wt, tr in zip(got, want, truth)]
            err, ok = max(c[0] for c in checks), all(c[1] for c in checks)
            nbytes = glm.min_bytes(x, sup, *w, cs=256)
            nops = glm.flops(b, 67, 7, 32, 32, 256, sup.shape[0], order)
            bound_ms, bound_by = bound(nbytes, nops, dn)
            call = lambda: glm.gwnet_layer_forward(*args, order=order)
            row = {
                "dtype": dn, "B": b, "max_abs_err": err, "ok": ok,
                "check": "; ".join(c[2] for c in checks if c[2]),
                "ms": events_ms(call, 50), "cold_ms": events_ms_cold(call, 20, flush),
                "device_ms": device_ms(call, 50, "gwnet_layer_kernel"),
                "device_cold_ms": device_ms(call, 20, "gwnet_layer_kernel", flush),
                "plain_ms": events_ms(lambda: glm.gwnet_layer_reference(*args, order=order), 10),
                "library_ms": None, "bytes": nbytes, "flop": nops, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "smem_bytes": glm.smem_bytes(67, 32, 32, 256, sup.shape[0], order, dtype),
            }
            log("gwnet_layer", json.dumps(row))
            rows.append(row)
            if not ok:
                failures.append(f"gwnet_layer {dn} B={b}: max err {err}")
    # gradients, float32, B=8
    w = [st[k].cuda().contiguous() for k in names]
    sup = gsm.adaptive_supports(torch.eye(67, device="cuda")[None], st["nodevec1"].cuda(),
                                st["nodevec2"].cuda())
    x = torch.randn(8, 67, 7, 32, generator=gen, device="cuda")
    cot = (torch.randn(8, 67, 7, 32, generator=gen, device="cuda"),
           torch.randn(8, 67, 7, 256, generator=gen, device="cuda"))
    grads = []
    for fn in (glm.fused_gwnet_layer, glm.gwnet_layer_reference):
        leaves = [a.clone().requires_grad_() for a in (x, sup, *w)]
        torch.autograd.backward(fn(*leaves, order=order), cot)
        grads.append([v.grad for v in leaves])
    torch.cuda.synchronize()
    worst = max(float((g - r).abs().max()) / (float(r.abs().max()) + 1e-30) for g, r in zip(*grads))
    ok = all(compare(g, r)[1] for g, r in zip(*grads)) and float(grads[0][1].abs().max()) > 0
    log(f"phase 3d: float32 B=8 gradients through the kernel vs autograd of the plain "
        f"version: worst leaf max|Δ|/max|g| {worst:.3g} (x, supports, 8 weights), ok {ok}")
    if not ok:
        failures.append(f"gwnet_layer gradients: worst {worst}")
    return rows, failures


def check_dcrnn_stack(torch, dsm, weights, gen):
    """Phase 3e: the DCRNN kernel at full width (2 DCGRU layers, 64
    units, diffusion order 2, S=2 dual-random-walk supports of the
    Florida graph, input 320, output 256, T = horizon = 7) at B = 1 and
    16, bf16 and float32, beside the plain version and the DCRNN module
    (models/dcrnn.py) in eval at the same B."""
    from multimodal_outage_tpu_torch.core.config import ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.models.dcrnn import DCRNN

    rows, failures = [], []
    cfg = ModelConfig(st_gnn="dcrnn")
    d = cfg.dcrnn
    st = weights.init_variables(cfg, 7, 67, seed=1)["params"]["st_gnn"]
    arch = dict(num_rnn_layers=d.num_rnn_layers, max_diffusion_step=d.max_diffusion_step,
                rnn_units=d.rnn_units)
    kw = dict(horizon=7, **arch)
    sup32 = torch.from_numpy(model_supports(cfg, 67)).cuda()
    sp_raw = dsm.dcrnn_stack_params(st, n_supports=sup32.shape[0], input_dim=cfg.st_gnn_in_dim,
                                    output_dim=cfg.feature_vector_size, **arch)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        sp = dsm.stack_params_to(sp_raw, "cuda", dtype)
        sup = sup32.to(dtype).contiguous()
        module = DCRNN(cfg.st_gnn_in_dim, cfg.feature_vector_size, n_supports=sup.shape[0],
                       dtype=dtype, **kw)
        weights.load_variables(module, {"params": st})
        module.cuda().eval()
        for b in (1, 16):
            x = torch.randn(b, 67, 7, cfg.st_gnn_in_dim, generator=gen, device="cuda").to(dtype)
            got = dsm.dcrnn_stack_forward(x, sup, sp, **kw)
            want = dsm.stack_forward_reference(x, sup, sp, **kw)
            truth = None
            if dtype != torch.float32:
                truth = dsm.stack_forward_reference(
                    x.float(), sup.float(), dsm.stack_params_to(sp, "cuda", torch.float32), **kw)
            torch.cuda.synchronize()
            err, ok, note = compare(got, want, truth)
            with torch.inference_mode():
                t_m = events_ms(lambda: module(x, sup), 3)
            nbytes = dsm.min_bytes(x, sup, sp, 7)
            dims = (b, 67, 7, 7, cfg.st_gnn_in_dim, cfg.feature_vector_size, d.rnn_units,
                    d.num_rnn_layers, sup.shape[0], d.max_diffusion_step)
            nops = dsm.flops(*dims)
            bound_ms, bound_by = bound(nbytes, nops, dn)
            row = {
                "dtype": dn, "B": b, "max_abs_err": err, "ok": ok, "check": note,
                "ms": events_ms(lambda: dsm.dcrnn_stack_forward(x, sup, sp, **kw), 5),
                "plain_ms": events_ms(lambda: dsm.stack_forward_reference(x, sup, sp, **kw), 3),
                "module_ms": t_m, "library_ms": None, "bytes": nbytes, "flop": nops,
                "bound_ms": bound_ms, "bound_by": bound_by,
                # share of the multiply-adds in the projections (term ×
                # weight, h_top·P); the bf16 body runs them and the chains
                # on mma.sync, the float32 body neither
                "proj_share": dsm.flops(*dims, part="proj") / nops,
            }
            log("dcrnn_stack", json.dumps(row))
            rows.append(row)
            if not ok:
                failures.append(f"dcrnn_stack {dn} B={b}: max err {err} {note}")
    return rows, failures


def serve_dcrnn_end_to_end(torch, cli, dcm, dsm, gsm, store_dir):
    """Phase 4c: `serve --st_gnn dcrnn` at B=1 and B=16, full width,
    through the CLI's code path; the launch counters are set to 0 just
    before and read just after each run."""
    common = ["serve", "--st_gnn", "dcrnn", "--data_dir", store_dir, "--case", "michael",
              "--dataset_range", "24", "--seed", "0", "--latency_stats"]
    counters = (dcm.fused_double_conv, dsm.dcrnn_stack_forward, gsm.gwnet_stack_forward)
    runs, n_dcrnn = {}, 0
    for b, k in ((1, 3), (16, 2)):
        for c in counters:
            c.launches = 0
        out = cli.run(common + ["--batch_size", str(b), "--max_batches", str(k)])
        torch.cuda.synchronize()
        grew = tuple(c.launches for c in counters)
        f = out["forwards"]
        log(f"serve --st_gnn dcrnn B={b}: {json.dumps(out)} launches (double_conv, "
            f"dcrnn_stack, gwnet_stack) {grew}")
        if grew != (9 * f, f, 0):
            raise RuntimeError(f"serve dcrnn B={b}: {f} forwards launched {grew}, "
                               f"expected {(9 * f, f, 0)}")
        if not all(math.isfinite(v) for v in (*out["metrics"].values(), *out["latency"].values())):
            raise RuntimeError(f"serve dcrnn B={b}: non-finite metrics {out}")
        runs[b] = out
        n_dcrnn += grew[1]
    return runs, n_dcrnn


def train_gwnet_layer_end_to_end(torch, glm, mp, train_store, workdir):
    """Phase 6: one epoch of `fit` at full width (bf16, B=8) with
    GWNetConfig(use_pallas=True) and pool="pallas": every Graph WaveNet
    layer of every train step and eval forward goes through the per-layer
    kernel; the launch counters are set to 0 just before fit and read
    just after."""
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
    from multimodal_outage_tpu_torch.core.config import (
        Config,
        DataConfig,
        GWNetConfig,
        ModelConfig,
        TrainConfig,
    )
    from multimodal_outage_tpu_torch.train.loop import fit

    model = ModelConfig(pool="pallas", gwnet=GWNetConfig(use_pallas=True))
    cfg = Config(
        data=DataConfig(data_dir=train_store, horizon=7, dataset_range=TRAIN_MARGIN),
        model=model, train=TrainConfig(epochs=1, batch_size=8, seed=0, job_id="smoke_layer"),
    )
    run_dir = os.path.join(workdir, "logs", "smoke_layer")
    for c in (glm.gwnet_layer_forward, mp.max_pool_forward, mp.max_pool_backward):
        c.launches = 0
    out = fit(cfg, test_case="michael", run_dir=run_dir, progress=False, device="cuda")
    torch.cuda.synchronize()
    layer = glm.gwnet_layer_forward.launches
    pool = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
    steps, evals = out["train_steps"], out["eval_forwards"]
    log(f"phase 6: fit use_pallas {json.dumps(out)}")
    want = (8 * (steps + evals), (4 * steps + 4 * evals, 4 * steps))
    log(f"phase 6: {steps} train steps, {evals} eval forwards: gwnet_layer launches {layer}, "
        f"pool (fwd, bwd) {pool}, expected {want}")
    if steps < 2 or (layer, pool) != want:
        raise RuntimeError(f"phase 6: launches {(layer, pool)}, expected {want}")
    finals = [v for k, v in out.items() if k.startswith(("val_", "test_"))]
    if len(finals) != 8 or not all(math.isfinite(v) for v in finals):
        raise RuntimeError(f"phase 6: non-finite or missing final metrics {out}")
    tree = CheckpointManager(os.path.join(run_dir, "checkpoints")).restore()
    init = weights.init_variables(model, 7, 67, seed=0)["params"]["st_gnn"]
    moved = {k: float((tree["params"]["st_gnn"][k] - init[k]).abs().max())
             for k in ("nodevec1", "nodevec2")}
    log(f"phase 6: node embeddings moved from their init by max |Δ| {moved}; train step "
        f"p50 {out['train_step_ms_p50']:.3f} ms (CUDA events, B=8 bf16, after the first step)")
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"phase 6: the node embeddings did not move: {moved}")
    return out, layer


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


def engine_vs_plain(torch, store_dir, st_gnn="gwnet", gwnet=None, **engine_kw):
    """Phases 4b, 4d, 9c and 10d: one full-width B=16 batch through a kernel
    engine and through the same engine on the plain versions, on the card,
    in bf16 and float32. engine_kw picks the st-GNN path (ServingModel's
    gwnet_stack / gwnet_pallas / dcrnn_stack); gwnet, a GWNetConfig, the
    Graph WaveNet's supports and branch (phase 9c: its adjtype and
    addaptadj; 10d: gcn_bool and kernel_size, the eval-mode module)."""
    from multimodal_outage_tpu_torch.core.config import (
        DEFAULT_NTL_MEAN,
        DEFAULT_NTL_STD,
        GWNetConfig,
        ModelConfig,
    )
    from multimodal_outage_tpu_torch.core.registry import HURRICANES
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.data.dataset import WindowDataset
    from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.serving import ServingModel
    from multimodal_outage_tpu_torch.weights import init_variables

    store = load_store(store_dir)
    ds = WindowDataset.from_case_study(store, {"michael": HURRICANES["michael"]}, 24, 7)
    gw = gwnet or GWNetConfig()
    cfg = lambda dn: ModelConfig(compute_dtype=dn, st_gnn=st_gnn, gwnet=gw)
    sup = model_supports(cfg("bfloat16"), 67, store.county_names)
    failures = []
    var = init_variables(cfg("bfloat16"), 7, 67, seed=0)
    engines = {
        (dn, ref): ServingModel(cfg(dn), var, sup, device="cuda", reference=ref, **engine_kw)
        for dn in ("bfloat16", "float32") for ref in (False, True)
    }
    pipe = DevicePipeline(store, DEFAULT_NTL_MEAN, DEFAULT_NTL_STD, 128,
                          torch.bfloat16, torch.device("cuda"))
    batch = pipe.batch(ds, list(range(16)))
    x, feats = batch["x"], batch["date_feats"]
    out = {k: e(x, feats) for k, e in engines.items()}
    torch.cuda.synchronize()
    label = " ".join([st_gnn] + [f"{k}={v}" for k, v in engine_kw.items()]
                     + [f"adjtype={gw.adjtype} addaptadj={gw.addaptadj} gcn_bool={gw.gcn_bool} "
                        f"kernel_size={gw.kernel_size}"] * (gwnet is not None))
    # the float32 plain engine on the same (bf16-rounded) frames is the
    # accuracy yardstick for the bf16 engines
    for dn, truth in (("bfloat16", out[("float32", True)]), ("float32", None)):
        got, want = out[(dn, False)], out[(dn, True)]
        err, ok, note = compare(got, want, truth)
        ok = ok and tuple(got.shape) == (16, 67, 7, 128, 128, 1)
        log(f"engine vs plain engine ({label}) {dn} B=16: shape {tuple(got.shape)} max abs "
            f"err {err} output rms {float(want.square().mean().sqrt()):.4g} {note} ok {ok}")
        if not ok:
            failures.append(f"engine ({label}) {dn}: max err {err} {note}")
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
                    "max_abs_err": err, "ok": err == 0.0, "ms": events_ms(kern, 20),
                    "plain_ms": events_ms(plain, 5), "library_ms": events_ms(lib, 20),
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


def train_batch(torch, store_dir):
    """(store, first 8 train windows of phase 5's store on the card)."""
    from multimodal_outage_tpu_torch.core.config import DEFAULT_NTL_MEAN, DEFAULT_NTL_STD
    from multimodal_outage_tpu_torch.core.registry import HURRICANES
    from multimodal_outage_tpu_torch.data.dataset import WindowDataset
    from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline
    from multimodal_outage_tpu_torch.data.store import load_store

    store = load_store(store_dir)
    cases = {k: HURRICANES[k] for k in ("ian", "idalia")}
    ds = WindowDataset.from_case_study(store, cases, TRAIN_MARGIN, 7)
    pipe = DevicePipeline(store, DEFAULT_NTL_MEAN, DEFAULT_NTL_STD, 128,
                          torch.bfloat16, torch.device("cuda"))
    return store, pipe.batch(ds, list(range(8)))


def step_vs_plain(torch, store_dir, label="5b", rtol=STEP_RTOL, **model_kw):
    """Phases 5b and 8a: one full-width B=8 train step with the pool
    kernels against the same step with the plain pool, on the card;
    model_kw are ModelConfig fields (phase 8a: DCRNN with teacher
    forcing), the supports those of its st-GNN."""
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import make_train_step

    store, batch = train_batch(torch, store_dir)
    sup = torch.from_numpy(model_supports(ModelConfig(**model_kw), 67, store.county_names)).cuda()
    var = weights.init_variables(ModelConfig(**model_kw), 7, 67, seed=3)

    def one_step(dtype: str, plain: bool):
        cfg = ModelConfig(compute_dtype=dtype, pool="pallas", **model_kw)
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
    ok = abs(lk - lp) <= rtol * abs(lp) and worst_g <= rtol and worst_s <= rtol
    log(f"phase {label}: float32 B=8 step, kernels vs plain pool: loss {lk!r} vs {lp!r}, "
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
    log(f"phase {label}: bfloat16 B=8 step: loss {lb!r} (plain {lpb!r}, float32 {lp!r}) {note_l}; "
        f"{len(gpb) - len(bad)} of {len(gpb)} grad leaves within the ratio bar")
    if not ok_l or bad:
        failures.append(f"bfloat16 step: loss ok {ok_l}, leaves off {bad[:5]}")
    return failures


def checkpoint_end_to_end(torch, cli, dcm, dsm, gsm, mp, workdir, store_dir, train_store,
                          trained, dcrnn_b1):
    """Phase 7: the readers of a checkpoint at full width, each through the
    CLI's code path with the launch counters set to 0 just before and read
    just after its run. (a) `evaluate --pool pallas` of phase 5's
    checkpoint: 4 pool forwards per batch and phase 5's test metrics to
    EVAL_RTOL; (b) `serve --checkpoint_path` of the same checkpoint: 9
    DoubleConv and 1 stack launches per forward, loss, MAE and RMSE within
    SERVE_RTOL of (a) (BN folded in bf16 against the module); (c) `serve
    --checkpoint_path --st_gnn dcrnn` of the tree `serve --seed 0` builds,
    saved through the port's CheckpointManager: phase 4c's B=1 metrics
    exactly, 1 dcrnn_stack launch per forward."""
    import numpy as np

    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
    from multimodal_outage_tpu_torch.core.config import ModelConfig

    ckpt = os.path.join(workdir, "logs", "smoke", "checkpoints")
    preds_dir, metrics_json = os.path.join(workdir, "preds"), os.path.join(workdir, "test.json")
    mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
    t0 = time.perf_counter()
    ev = cli.run(["evaluate", "--checkpoint_path", ckpt, "--case", "michael", "--pool", "pallas",
                  "--batch_size", "8", "--dataset_range", str(TRAIN_MARGIN), "--data_dir",
                  train_store, "--save_preds", preds_dir, "--metrics_json", metrics_json])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pool = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
    f = ev["forwards"]
    gap = max(abs(ev["metrics"][k] - trained[f"test_{k}"]) / abs(trained[f"test_{k}"])
              for k in METRICS)
    preds = np.load(os.path.join(preds_dir, "preds.npy"), mmap_mode="r")
    shape = (ev["windows"], 67, 7, 128, 128, 1)
    log(f"phase 7a: evaluate {json.dumps(ev)}; {wall:.3f} s wall (store to the card, model "
        f"build, {f} forwards); pool launches (fwd, bwd) {pool}; largest relative difference "
        f"from phase 5's test metrics {gap!r}; preds {preds.shape} {preds.dtype}")
    if pool != (4 * f, 0):
        raise RuntimeError(f"phase 7a: {f} forwards launched pools {pool}, expected {(4 * f, 0)}")
    if gap > EVAL_RTOL:
        raise RuntimeError(f"phase 7a: test metrics {ev['metrics']} differ from phase 5's {trained}")
    if preds.shape != shape or preds.dtype != np.float32 or ev["windows"] != 18:
        raise RuntimeError(f"phase 7a: preds {preds.shape} {preds.dtype}, expected {shape} float32")
    with open(metrics_json) as fh:
        if json.load(fh) != ev["metrics"]:
            raise RuntimeError("phase 7a: --metrics_json differs from the printed metrics")
    del preds
    shutil.rmtree(preds_dir)

    dcm.fused_double_conv.launches = gsm.gwnet_stack_forward.launches = 0
    sv = cli.run(["serve", "--checkpoint_path", ckpt, "--case", "michael", "--batch_size", "8",
                  "--dataset_range", str(TRAIN_MARGIN), "--data_dir", train_store,
                  "--latency_stats"])
    torch.cuda.synchronize()
    grew, f = (dcm.fused_double_conv.launches, gsm.gwnet_stack_forward.launches), sv["forwards"]
    gaps = {k: abs(sv["metrics"][k] - ev["metrics"][k]) / abs(ev["metrics"][k])
            for k in ("loss", "mae", "rmse")}
    log(f"phase 7b: serve --checkpoint_path B=8 {json.dumps(sv)} launches (double_conv, "
        f"gwnet_stack) {grew}; relative gaps to evaluate {json.dumps(gaps)}")
    if grew != (9 * f, f):
        raise RuntimeError(f"phase 7b: {f} forwards launched {grew}, expected {(9 * f, f)}")
    if max(gaps.values()) > SERVE_RTOL:
        raise RuntimeError(f"phase 7b: serve {sv['metrics']} vs evaluate {ev['metrics']}")

    d_ckpt = os.path.join(workdir, "dcrnn_checkpoints")
    tree = weights.init_variables(ModelConfig(st_gnn="dcrnn"), 7, 67, seed=0)
    CheckpointManager(d_ckpt).save(0, tree, metrics={"val_loss": 0.0})
    counters = (dcm.fused_double_conv, dsm.dcrnn_stack_forward, gsm.gwnet_stack_forward)
    for c in counters:
        c.launches = 0
    sd = cli.run(["serve", "--checkpoint_path", d_ckpt, "--st_gnn", "dcrnn", "--data_dir",
                  store_dir, "--case", "michael", "--dataset_range", "24", "--batch_size", "1",
                  "--max_batches", "3", "--latency_stats"])
    torch.cuda.synchronize()
    grew, f = tuple(c.launches for c in counters), sd["forwards"]
    log(f"phase 7c: serve --checkpoint_path --st_gnn dcrnn B=1 {json.dumps(sd)} launches "
        f"(double_conv, dcrnn_stack, gwnet_stack) {grew}")
    if grew != (9 * f, f, 0):
        raise RuntimeError(f"phase 7c: {f} forwards launched {grew}, expected {(9 * f, f, 0)}")
    if sd["metrics"] != dcrnn_b1["metrics"]:
        raise RuntimeError(f"phase 7c: {sd['metrics']} differ from --seed 0's {dcrnn_b1['metrics']}")
    for name, out in (("7b serve gwnet B=8", sv), ("7c serve dcrnn B=1", sd)):
        log(f"phase {name} from a checkpoint: p50 {out['latency']['p50_ms']:.3f} ms "
            f"p90 {out['latency']['p90_ms']:.3f} ms")
    return {"evaluate_s": wall, "evaluate_forwards": ev["forwards"], "round_trip_gap": gap,
            "serve_gaps": gaps}


def step_busy_share(torch, store_dir, steps=3, **model_kw):
    """Phase 8a: the device's busy share of a full-width B=8 bf16 train
    step with the pool kernels: torch.profiler's device time of every
    kernel over `steps` steps against their CUDA-event wall time, after
    two warm-up steps. A share well under 1 is a step the host holds
    back (the DCRNN module issues ~1000 small ops per forward)."""
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import make_train_step

    store, batch = train_batch(torch, store_dir)
    cfg = ModelConfig(pool="pallas", **model_kw)
    sup = torch.from_numpy(model_supports(cfg, 67, store.county_names)).cuda()
    model = weights.load_variables(build_model(cfg, 7, 67, 128),
                                   weights.init_variables(cfg, 7, 67, seed=3)).cuda()
    state, step = create_train_state(model), make_train_step(model)
    for _ in range(2):
        step(state, batch, sup, 1e-3, 0)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(steps):
            step(state, batch, sup, 1e-3, 0)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / steps
    busy = sum(ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / steps
    if not busy:
        raise RuntimeError("phase 8a: the profiler caught no device time")
    return {"step_ms": wall, "device_busy_ms": busy, "device_busy_share": busy / wall}


def train_dcrnn_end_to_end(torch, cli, dcm, dsm, gsm, mp, workdir, train_store):
    """Phase 8: DCRNN training at full width (the default DCRNNConfig:
    2 DCGRU layers, 64 units, order 2, dual-random-walk supports of the
    Florida graph), bf16, B=8, each run through the CLI's code path with
    the launch counters set to 0 just before and read just after it.
    (a) a teacher-forcing (p = 1) step with the pool kernels against the
    same step with the plain pool, and the step's device-busy share;
    (b) `train --st_gnn dcrnn --pool pallas --teacher_forcing 0.5
    --tf_decay_steps 20`, one epoch on phase 5's store: 8 pool forwards
    (4 on the eval-mode teacher pass) and 4 backwards per step, 4
    forwards per eval batch; (c) `evaluate --st_gnn dcrnn --pool pallas`
    of its checkpoint: its test metrics exactly; (d) `serve
    --checkpoint_path --st_gnn dcrnn` B=8 of it: 9 DoubleConv and 1 DCRNN
    kernel launches per forward, loss, MAE and RMSE within SERVE_RTOL of
    (c)."""
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
    from multimodal_outage_tpu_torch.core.config import DCRNNConfig, ModelConfig

    f8a = step_vs_plain(torch, train_store, label="8a", rtol=DCRNN_STEP_RTOL, st_gnn="dcrnn",
                        dcrnn=DCRNNConfig(teacher_forcing=1.0))
    if f8a:
        raise RuntimeError("phase 8a: kernel step disagrees with the plain step:\n"
                           + "\n".join(f8a))
    busy = step_busy_share(torch, train_store, st_gnn="dcrnn",
                           dcrnn=DCRNNConfig(teacher_forcing=0.5, tf_decay_steps=20))
    log(f"phase 8a: DCRNN teacher-forcing step, bf16 B=8: {json.dumps(busy)}")

    cwd = os.getcwd()
    os.chdir(workdir)  # the run directory is ./logs/<job_id>
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
        t0 = time.perf_counter()
        out = cli.run(["train", "--st_gnn", "dcrnn", "--teacher_forcing", "0.5",
                       "--tf_decay_steps", "20", "--data_dir", train_store, "--case", "michael",
                       "--dataset_range", str(TRAIN_MARGIN), "--epochs", "1", "--batch_size",
                       "8", "--seed", "0", "--pool", "pallas", "--job_id", "smoke_dcrnn"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pool = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(cwd)
    steps, evals = out["train_steps"], out["eval_forwards"]
    want = (8 * steps + 4 * evals, 4 * steps)
    log(f"phase 8b: train --st_gnn dcrnn {json.dumps(out)}; {wall:.3f} s wall; pool launches "
        f"(fwd, bwd) {pool}, expected {want}")
    if steps < 2 or pool != want:
        raise RuntimeError(f"phase 8b: pool launches {pool}, expected {want}")
    finals = [v for k, v in out.items() if k.startswith(("val_", "test_"))]
    if len(finals) != 8 or not all(math.isfinite(v) for v in finals):
        raise RuntimeError(f"phase 8b: non-finite or missing final metrics {out}")
    ckpt = os.path.join(workdir, "logs", "smoke_dcrnn", "checkpoints")
    tree = CheckpointManager(ckpt).restore()
    init = weights.flatten(
        weights.init_variables(ModelConfig(st_gnn="dcrnn"), 7, 67, seed=0)["params"])
    st = {k: v for k, v in weights.flatten(tree["params"]).items() if k.startswith("st_gnn/")}
    still = [k for k, v in st.items() if torch.equal(v, init[k])]
    if tree["step"] != steps or still or not st:
        raise RuntimeError(f"phase 8b: checkpoint step {tree['step']} of {steps}; DCRNN "
                           f"leaves that did not move: {still}")
    log(f"phase 8b: all {len(st)} DCRNN parameter leaves moved from their init; train step "
        f"p50 {out['train_step_ms_p50']:.3f} ms (CUDA events, B=8 bf16, after the first "
        f"step); peak memory {peak / 2**30:.2f} GiB; device busy share "
        f"{busy['device_busy_share']:.3f} (8a)")

    mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
    ev = cli.run(["evaluate", "--st_gnn", "dcrnn", "--checkpoint_path", ckpt, "--case",
                  "michael", "--pool", "pallas", "--batch_size", "8", "--dataset_range",
                  str(TRAIN_MARGIN), "--data_dir", train_store])
    torch.cuda.synchronize()
    pool, f = (mp.max_pool_forward.launches, mp.max_pool_backward.launches), ev["forwards"]
    gap = max(abs(ev["metrics"][k] - out[f"test_{k}"]) / abs(out[f"test_{k}"]) for k in METRICS)
    log(f"phase 8c: evaluate --st_gnn dcrnn {json.dumps(ev)}; pool launches (fwd, bwd) {pool}; "
        f"largest relative difference from 8b's test metrics {gap!r}")
    if pool != (4 * f, 0):
        raise RuntimeError(f"phase 8c: {f} forwards launched pools {pool}, expected {(4 * f, 0)}")
    if gap != 0.0:
        raise RuntimeError(f"phase 8c: test metrics {ev['metrics']} differ from 8b's {out}")

    counters = (dcm.fused_double_conv, dsm.dcrnn_stack_forward, gsm.gwnet_stack_forward)
    for c in counters:
        c.launches = 0
    sv = cli.run(["serve", "--checkpoint_path", ckpt, "--st_gnn", "dcrnn", "--case", "michael",
                  "--batch_size", "8", "--dataset_range", str(TRAIN_MARGIN), "--data_dir",
                  train_store, "--latency_stats"])
    torch.cuda.synchronize()
    grew, f = tuple(c.launches for c in counters), sv["forwards"]
    gaps = {k: abs(sv["metrics"][k] - ev["metrics"][k]) / abs(ev["metrics"][k])
            for k in ("loss", "mae", "rmse")}
    log(f"phase 8d: serve --checkpoint_path --st_gnn dcrnn B=8 {json.dumps(sv)} launches "
        f"(double_conv, dcrnn_stack, gwnet_stack) {grew}; relative gaps to 8c "
        f"{json.dumps(gaps)}")
    if grew != (9 * f, f, 0):
        raise RuntimeError(f"phase 8d: {f} forwards launched {grew}, expected {(9 * f, f, 0)}")
    if max(gaps.values()) > SERVE_RTOL:
        raise RuntimeError(f"phase 8d: serve {sv['metrics']} vs evaluate {ev['metrics']}")
    return {"train_step_ms_p50": out["train_step_ms_p50"], "peak_gib": peak / 2**30,
            **busy, "train_s": wall, "train_steps": steps, "eval_forwards": evals,
            "pool_launches": want, "round_trip_gap": gap, "serve_gaps": gaps,
            "serve_p50_ms": sv["latency"]["p50_ms"], "serve_launches": grew}


def _rel_gap(a, b):
    """max |a − b| / max |b| over two trees of tensors and numbers (0 where
    both are all zero)."""
    import torch

    if isinstance(a, dict):
        return max([_rel_gap(a[k], b[k]) for k in b] or [0.0])
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    scale = float(b.abs().max()) if b.numel() else 0.0
    diff = float((a - b).abs().max()) if b.numel() else 0.0
    return diff / scale if scale else diff


def resume_end_to_end(torch, cli, mp, workdir, train_store):
    """Phase 9a: `train --pool pallas --epochs 1` at full width (bf16, B=8,
    phase 5's store), then `--epochs 4 --resume --tensorboard
    --profile_dir` of the same job: 15 steps in the resumed process, its
    pool launches counted from 0 around exactly that run, the val rows of
    epochs 0-3 once each, the last checkpoint at step 20 with an Adam count
    of 20, a Chrome trace naming both max-pool kernels. Then in float32
    (deterministic cuDNN, no TF32) `--epochs 2` straight against `--epochs
    1` and `--resume --epochs 2`: the last checkpoints (params, BN
    statistics, Adam state) and the final metrics within RESUME_RTOL."""
    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager

    base = ["train", "--data_dir", train_store, "--case", "michael", "--dataset_range",
            str(TRAIN_MARGIN), "--batch_size", "8", "--seed", "0", "--pool", "pallas"]
    run_dir, prof_dir = os.path.join(workdir, "logs", "resume"), os.path.join(workdir, "profile")
    cwd = os.getcwd()
    os.chdir(workdir)  # the run directory is ./logs/<job_id>
    try:
        first = cli.run(base + ["--epochs", "1", "--job_id", "resume"])
        mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
        t0 = time.perf_counter()
        out = cli.run(base + ["--epochs", "4", "--resume", "--tensorboard", "--profile_dir",
                              prof_dir, "--job_id", "resume"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pool = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
        torch.backends.cudnn.deterministic = True
        try:
            f32 = base + ["--compute_dtype", "float32"]
            straight = cli.run(f32 + ["--epochs", "2", "--job_id", "f32_straight"])
            cli.run(f32 + ["--epochs", "1", "--job_id", "f32_resumed"])
            resumed = cli.run(f32 + ["--epochs", "2", "--resume", "--job_id", "f32_resumed"])
        finally:
            torch.backends.cudnn.deterministic = False
    finally:
        os.chdir(cwd)
    local = out["train_steps"] - first["train_steps"]
    evals = out["eval_forwards"]
    want = (4 * local + 4 * evals, 4 * local)
    log(f"phase 9a: train --resume {json.dumps(out)}; {wall:.3f} s wall; {local} steps in "
        f"this process, {evals} eval forwards: pool launches (fwd, bwd) {pool}, expected {want}")
    if local != 15 or pool != want:
        raise RuntimeError(f"phase 9a: {local} local steps, pool launches {pool}, expected "
                           f"15 and {want}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        val_epochs = [r["epoch"] for r in map(json.loads, f) if r["phase"] == "val"]
    tree = CheckpointManager(os.path.join(run_dir, "checkpoints")).restore_latest()
    log(f"phase 9a: val rows of epochs {val_epochs}; last checkpoint step {tree['step']}, "
        f"Adam count {tree['opt_state']['count']}")
    if val_epochs != [0, 1, 2, 3] or tree["step"] != 20 or tree["opt_state"]["count"] != 20:
        raise RuntimeError("phase 9a: the resumed run's rows or checkpoint are off")
    trace = os.path.join(prof_dir, "trace.json")
    with open(trace) as f:
        text = f.read()
    names = {k: k in text for k in ("max_pool_fwd_kernel", "max_pool_bwd_kernel")}
    log(f"phase 9a: profiler trace {os.path.getsize(trace)} bytes; names {names}")
    if not all(names.values()):
        raise RuntimeError(f"phase 9a: the trace misses a max-pool kernel: {names}")
    events = glob.glob(os.path.join(run_dir, "tb", "events.out.tfevents*"))
    writers = [m for m in ("tensorboardX", "torch.utils.tensorboard") if _importable(m)]
    log(f"phase 9a: TensorBoard writers importable {writers}; event files {len(events)}"
        + ("" if writers else " (the warning branch: metrics.jsonl only)"))
    if bool(writers) != bool(events):
        raise RuntimeError("phase 9a: TensorBoard event files do not match the writers found")
    a = CheckpointManager(os.path.join(workdir, "logs", "f32_straight", "checkpoints"))
    b = CheckpointManager(os.path.join(workdir, "logs", "f32_resumed", "checkpoints"))
    ta, tb = a.restore_latest(), b.restore_latest()
    gaps = {k: _rel_gap(tb[k], ta[k]) for k in ("params", "batch_stats")}
    gaps.update({f"adam_{k}": _rel_gap(tb["opt_state"][k], ta["opt_state"][k])
                 for k in ("mu", "nu")})
    finals = [k for k in straight if k.startswith(("val_", "test_"))]
    gaps["metrics"] = max(abs(resumed[k] - straight[k]) / abs(straight[k]) for k in finals)
    exact = (ta["step"], ta["opt_state"]["count"]) == (tb["step"], tb["opt_state"]["count"])
    log(f"phase 9a: float32 resumed vs straight, relative gaps {json.dumps(gaps)}; steps "
        f"{(ta['step'], tb['step'])}, Adam counts equal {exact}")
    if max(gaps.values()) > RESUME_RTOL or not exact:
        raise RuntimeError(f"phase 9a: the resumed float32 run is not the straight one: {gaps}")
    return {"train_step_ms_p50": out["train_step_ms_p50"], "resume_wall_s": wall,
            "pool_launches": pool, "f32_gap": max(gaps.values()), "tb_events": len(events)}


def _importable(module: str) -> bool:
    try:
        importlib.import_module(module)
        return True
    except ImportError:
        return False


def date2vec_end_to_end(torch, cli, workdir, train_store):
    """Phase 9b: `pretrain-d2v` on the card at its defaults (k = 64, 2000
    steps, batch 256): a finite final loss, logged beside the step-0 loss;
    then `train --d2v_bundle <it> --epochs 1 --pool pallas`: the
    checkpoint's frozen date2vec fc1/fc2 are the bundle's, bitwise."""
    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
    from multimodal_outage_tpu_torch.train.date2vec_pretrain import (
        load_bundle,
        pretrain_date2vec,
    )

    bundle_path = os.path.join(workdir, "d2v", "d2v.npz")
    _, loss0 = pretrain_date2vec(steps=1, device="cuda")
    t0 = time.perf_counter()
    res = cli.run(["pretrain-d2v", "--out", bundle_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"phase 9b: pretrain-d2v {json.dumps(res)}; {wall:.3f} s wall; step-0 loss {loss0!r}")
    if not math.isfinite(res["final_loss"]) or res["final_loss"] >= loss0:
        raise RuntimeError(f"phase 9b: final loss {res['final_loss']} from {loss0}")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        cli.run(["train", "--data_dir", train_store, "--case", "michael", "--dataset_range",
                 str(TRAIN_MARGIN), "--batch_size", "8", "--seed", "0", "--pool", "pallas",
                 "--epochs", "1", "--d2v_bundle", bundle_path, "--job_id", "d2v"])
    finally:
        os.chdir(cwd)
    tree = CheckpointManager(os.path.join(workdir, "logs", "d2v", "checkpoints")).restore()
    bundle = load_bundle(bundle_path)
    same = {f"{k}/{p}": torch.equal(tree["params"]["date2vec"][k][p],
                                    torch.from_numpy(bundle[k][p]))
            for k in ("fc1", "fc2") for p in ("kernel", "bias")}
    log(f"phase 9b: train --d2v_bundle: checkpoint date2vec equals the bundle {same}")
    if not all(same.values()):
        raise RuntimeError(f"phase 9b: the checkpoint's date2vec is not the bundle's: {same}")
    return {"pretrain_s": wall, "loss0": loss0, "final_loss": res["final_loss"]}


def check_gwnet_layer_supports(torch, glm, gsm, weights, gen):
    """Phase 9c: the per-layer kernel at B=8, N=67, T=7, full width, order
    2, with S = 1 (the identity alone: --no_addaptadj) and S = 3 (the two
    Florida dual-random-walk supports and the adaptive one: --adjtype
    doubletransition), bf16 and float32, against its plain version; device
    ms from torch.profiler (None where a profile dropped launches). main
    runs it before phase 9a, whose profiled `train` is the process's
    longest profiler session."""
    from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports

    rows, failures = [], []
    names = [f"{k}0_{p}" for k in ("filter_conv", "gate_conv", "skip_conv", "gconv")
             for p in ("kernel", "bias")]
    for gw in (GWNetConfig(addaptadj=False), GWNetConfig(adjtype="doubletransition")):
        cfg = ModelConfig(gwnet=gw)
        st = weights.init_variables(cfg, 7, 67, seed=1)["params"]["st_gnn"]
        static = torch.from_numpy(model_supports(cfg, 67)).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            w = [st[k].to("cuda", dtype).contiguous() for k in names]
            node = [st[k].cuda() if k in st else None for k in ("nodevec1", "nodevec2")]
            sup = gsm.adaptive_supports(static, *node, dtype)
            x = torch.randn(8, 67, 7, 32, generator=gen, device="cuda").to(dtype)
            args = (x, sup, *w)
            got = glm.gwnet_layer_forward(*args, order=2)
            want = glm.gwnet_layer_reference(*args, order=2)
            truth = (None,) * 2
            if dtype != torch.float32:
                truth = glm.gwnet_layer_reference(*(a.float() for a in args), order=2)
            torch.cuda.synchronize()
            checks = [compare(g, wt, tr) for g, wt, tr in zip(got, want, truth)]
            err, ok = max(c[0] for c in checks), all(c[1] for c in checks)
            call = lambda: glm.gwnet_layer_forward(*args, order=2)
            try:
                dev_ms = device_ms(call, 50, "gwnet_layer_kernel")
            except RuntimeError as e:  # the profile dropped launches: no mean
                log(f"phase 9c: gwnet_layer {dn} S={sup.shape[0]} device ms not measured: {e}")
                dev_ms = None
            row = {
                "dtype": dn, "B": 8, "S": sup.shape[0], "max_abs_err": err, "ok": ok,
                "check": "; ".join(c[2] for c in checks if c[2]), "ms": events_ms(call, 50),
                "device_ms": dev_ms,
                "plain_ms": events_ms(lambda: glm.gwnet_layer_reference(*args, order=2), 10),
                "smem_bytes": glm.smem_bytes(67, 32, 32, 256, sup.shape[0], 2, dtype),
            }
            log("gwnet_layer", json.dumps(row))
            rows.append(row)
            if not ok:
                failures.append(f"gwnet_layer {dn} B=8 S={sup.shape[0]}: max err {err}")
    return rows, failures


def graph_flags_end_to_end(torch, cli, dcm, dsm, gsm, weights, store_dir, workdir, dcrnn_b1,
                           gen):
    """Phase 9c: the graph flags through kernels 2 and 5 at full width
    (kernel 3's part: check_gwnet_layer_supports). `serve --seed 0` with
    --adjtype doubletransition (S = 3) and with --adjtype transition
    --no_addaptadj (S = 1), B = 1 and 16, one kernel-2 launch per
    forward, each engine against the plain engine; kernel 2 alone at S = 3
    and 1 (phase 3b's check); `serve --st_gnn dcrnn --seed 0 --adjacency
    <a copy of the packaged CSV>`: phase 4c's B=1 metrics exactly."""
    from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import default_adjacency_path, model_supports

    common = ["serve", "--data_dir", store_dir, "--case", "michael", "--dataset_range", "24",
              "--seed", "0", "--latency_stats"]
    runs, stack_rows, failures = {}, [], []
    for s_count, flags, gw in (
        (3, ["--adjtype", "doubletransition"], GWNetConfig(adjtype="doubletransition")),
        (1, ["--adjtype", "transition", "--no_addaptadj"],
         GWNetConfig(adjtype="transition", addaptadj=False)),
    ):
        for b, k in ((1, 3), (16, 2)):
            dcm.fused_double_conv.launches = gsm.gwnet_stack_forward.launches = 0
            out = cli.run(common + flags + ["--batch_size", str(b), "--max_batches", str(k)])
            torch.cuda.synchronize()
            grew, f = (dcm.fused_double_conv.launches, gsm.gwnet_stack_forward.launches), \
                out["forwards"]
            log(f"phase 9c: serve S={s_count} {' '.join(flags)} B={b}: {json.dumps(out)} "
                f"launches (double_conv, gwnet_stack) {grew}")
            if grew != (9 * f, f):
                raise RuntimeError(f"phase 9c S={s_count} B={b}: {f} forwards launched {grew}")
            if not all(math.isfinite(v) for v in out["metrics"].values()):
                raise RuntimeError(f"phase 9c S={s_count} B={b}: non-finite metrics {out}")
            runs[(s_count, b)] = out
        cfg = ModelConfig(gwnet=gw)
        rows, f2 = check_gwnet_stack(torch, gsm, weights, cfg, gen,
                                     static=torch.from_numpy(model_supports(cfg, 67)).cuda(),
                                     label="9c")
        stack_rows += rows
        failures += f2 + engine_vs_plain(torch, store_dir, gwnet=gw)
    if failures:
        raise RuntimeError("phase 9c: a kernel disagrees with its plain version:\n"
                           + "\n".join(failures))
    copy = os.path.join(workdir, "adj_copy.csv")
    shutil.copyfile(default_adjacency_path(), copy)
    counters = (dcm.fused_double_conv, dsm.dcrnn_stack_forward, gsm.gwnet_stack_forward)
    for c in counters:
        c.launches = 0
    sd = cli.run(["serve", "--st_gnn", "dcrnn", "--data_dir", store_dir, "--case", "michael",
                  "--dataset_range", "24", "--seed", "0", "--latency_stats", "--batch_size", "1",
                  "--max_batches", "3", "--adjacency", copy])
    torch.cuda.synchronize()
    grew, f = tuple(c.launches for c in counters), sd["forwards"]
    log(f"phase 9c: serve --st_gnn dcrnn --adjacency <copy> B=1 {json.dumps(sd)} launches "
        f"(double_conv, dcrnn_stack, gwnet_stack) {grew}")
    if grew != (9 * f, f, 0) or sd["metrics"] != dcrnn_b1["metrics"]:
        raise RuntimeError(f"phase 9c: dcrnn --adjacency {sd['metrics']} launches {grew}, "
                           f"phase 4c {dcrnn_b1['metrics']}")
    for (s_count, b), out in runs.items():
        log(f"phase 9c: serve S={s_count} B={b} p50 {out['latency']['p50_ms']:.3f} ms "
            f"p90 {out['latency']['p90_ms']:.3f} ms")
    return stack_rows, {f"S{k[0]}_B{k[1]}_p50_ms": v["latency"]["p50_ms"]
                        for k, v in runs.items()}


def nonfused_gwnet_end_to_end(torch, cli, dcm, gsm, glm, mp, weights, workdir, store_dir,
                              train_store, gen):
    """Phase 10: the non-fused Graph WaveNet at full width, each CLI run with
    the launch counters set to 0 just before and read just after it.
    (a) `train --gwnet_kernel_size 2 --svd_aptinit --adjtype
    doubletransition --pool pallas --epochs 1 --batch_size 8` on phase 5's
    store: pool launches (4·steps + 4·evals, 4·steps), step p50, peak
    memory, and fit's initial node embeddings bitwise svd_aptinit of the
    first support. (b) `evaluate --checkpoint_path` of it at B=8: (a)'s
    test metrics exactly, 4 pool forwards per batch. (c) `serve
    --checkpoint_path` at B=1 and 16 (the eval-mode module: 9 DoubleConv
    launches per forward, no stack kernel) against `evaluate` at the same
    batch size, within SERVE_RTOL. (d) the engine against the plain engine
    for --no_gcn, --gwnet_kernel_size 2 and both, float32 and bf16 bars.
    (e) a float32 reference_view_quirk Graph WaveNet at kernel_size 1 with
    use_pallas (kernel 3 between the two reinterprets) against the plain
    module."""
    import dataclasses

    import numpy as np

    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
    from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import config_supports
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.models.gwnet import GraphWaveNet, svd_aptinit
    from multimodal_outage_tpu_torch.train import loop

    common = ["--case", "michael", "--dataset_range", str(TRAIN_MARGIN), "--data_dir",
              train_store, "--gwnet_kernel_size", "2", "--adjtype", "doubletransition"]
    argv = ["train", *common, "--pool", "pallas", "--svd_aptinit", "--epochs", "1",
            "--batch_size", "8", "--seed", "0", "--job_id", "k2"]
    cfg = cli._config(cli._parser().parse_args(argv))
    store = load_store(train_store)
    static = config_supports(cfg, store)
    init = loop._initial_variables(cfg, store.n_counties, static)["params"]["st_gnn"]
    svd = svd_aptinit(static[0], cfg.model.gwnet.node_embed_dim)
    svd_ok = all(np.array_equal(init[k].numpy(), e) for k, e in zip(("nodevec1", "nodevec2"), svd))
    cwd = os.getcwd()
    os.chdir(workdir)  # the run directory is ./logs/<job_id>
    try:
        torch.cuda.reset_peak_memory_stats()
        mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
        gsm.gwnet_stack_forward.launches = glm.gwnet_layer_forward.launches = 0
        out = cli.run(argv)
        torch.cuda.synchronize()
        pool = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
        others = (gsm.gwnet_stack_forward.launches, glm.gwnet_layer_forward.launches)
        peak = torch.cuda.max_memory_allocated()
    finally:
        os.chdir(cwd)
    steps, evals = out["train_steps"], out["eval_forwards"]
    want = (4 * steps + 4 * evals, 4 * steps)
    ckpt = os.path.join(workdir, "logs", "k2", "checkpoints")
    tree = CheckpointManager(ckpt).restore()
    moved = {k: float((tree["params"]["st_gnn"][k] - init[k]).abs().max())
             for k in ("nodevec1", "nodevec2")}
    log(f"phase 10a: train {' '.join(argv[1:])}: {json.dumps(out)}")
    log(f"phase 10a: {steps} train steps, {evals} eval forwards: pool launches (fwd, bwd) "
        f"{pool}, expected {want}; (gwnet_stack, gwnet_layer) {others}; initial nodevecs == "
        f"svd_aptinit(supports[0], 10) {svd_ok}, moved by max |Δ| {moved}; train step p50 "
        f"{out['train_step_ms_p50']:.3f} ms (CUDA events, B=8 bf16, after the first step); "
        f"peak memory {peak / 2**30:.2f} GiB")
    finals = [v for k, v in out.items() if k.startswith(("val_", "test_"))]
    if steps < 2 or pool != want or others != (0, 0):
        raise RuntimeError(f"phase 10a: launches {pool} {others}, expected {want} (0, 0)")
    if not svd_ok or not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"phase 10a: svd_aptinit {svd_ok}, nodevecs moved {moved}")
    if len(finals) != 8 or not all(math.isfinite(v) for v in finals):
        raise RuntimeError(f"phase 10a: non-finite or missing final metrics {out}")

    def evaluate(b):
        mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
        ev = cli.run(["evaluate", "--checkpoint_path", ckpt, "--batch_size", str(b), "--pool",
                      "pallas", *common])
        torch.cuda.synchronize()
        pool = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
        if pool != (4 * ev["forwards"], 0):
            raise RuntimeError(f"phase 10b: evaluate B={b}: {ev['forwards']} forwards "
                               f"launched pools {pool}")
        return ev

    ev = evaluate(8)
    gap = max(abs(ev["metrics"][k] - out[f"test_{k}"]) / abs(out[f"test_{k}"]) for k in METRICS)
    log(f"phase 10b: evaluate --checkpoint_path B=8 {json.dumps(ev)}; largest relative "
        f"difference from 10a's test metrics {gap!r}")
    if gap != 0.0:
        raise RuntimeError(f"phase 10b: test metrics {ev['metrics']} differ from 10a's {out}")

    serves = {}
    for b in (1, 16):
        ev_b = evaluate(b)
        dcm.fused_double_conv.launches = gsm.gwnet_stack_forward.launches = 0
        sv = cli.run(["serve", "--checkpoint_path", ckpt, "--batch_size", str(b),
                      "--latency_stats", *common])
        torch.cuda.synchronize()
        grew, f = (dcm.fused_double_conv.launches, gsm.gwnet_stack_forward.launches), \
            sv["forwards"]
        gaps = {k: abs(sv["metrics"][k] - ev_b["metrics"][k]) / abs(ev_b["metrics"][k])
                for k in ("loss", "mae", "rmse")}
        log(f"phase 10c: serve --checkpoint_path B={b} {json.dumps(sv)} launches (double_conv, "
            f"gwnet_stack) {grew}; relative gaps to evaluate at B={b} {json.dumps(gaps)}")
        if grew != (9 * f, 0):
            raise RuntimeError(f"phase 10c: {f} forwards launched {grew}, expected {(9 * f, 0)}")
        if max(gaps.values()) > SERVE_RTOL:
            raise RuntimeError(f"phase 10c: serve {sv['metrics']} vs evaluate {ev_b['metrics']}")
        serves[b] = {**sv["latency"], "gap": max(gaps.values())}

    failures = []
    for gw in (GWNetConfig(gcn_bool=False), GWNetConfig(kernel_size=2),
               GWNetConfig(gcn_bool=False, kernel_size=2)):
        failures += engine_vs_plain(torch, store_dir, gwnet=gw)

    # (e) the quirk on the fused path: kernel 3 between the reinterprets
    qcfg = ModelConfig(compute_dtype="float32",
                       gwnet=GWNetConfig(reference_view_quirk=True, use_pallas=True))
    n = store.n_counties
    st = weights.init_variables(qcfg, 7, n, seed=4)
    st = {k: st[k]["st_gnn"] for k in ("params", "batch_stats")}
    plain_cfg = dataclasses.replace(qcfg, gwnet=dataclasses.replace(qcfg.gwnet, use_pallas=False))
    mods = [weights.load_variables(GraphWaveNet(c, n, 1), st).cuda().eval()
            for c in (qcfg, plain_cfg)]
    z = torch.randn(8, n, 7, qcfg.st_gnn_in_dim, generator=gen, device="cuda")
    sup = torch.eye(n, device="cuda")[None]
    glm.gwnet_layer_forward.launches = 0
    with torch.no_grad():
        got = mods[0](z, sup, False)
        layer = glm.gwnet_layer_forward.launches
        want = mods[1](z, sup, False)
    torch.cuda.synchronize()
    err, ok, _ = compare(got, want)
    log(f"phase 10e: reference_view_quirk float32 B=8, kernel 3 between the reinterprets vs "
        f"the plain module: max abs err {err}, gwnet_layer launches {layer}, ok {ok}")
    if not ok or layer != 8:
        failures.append(f"quirk: max err {err}, {layer} launches")
    if failures:
        raise RuntimeError("phase 10: an engine disagrees with its plain version:\n"
                           + "\n".join(failures))
    for b, lat in serves.items():
        log(f"phase 10c: serve k=2 B={b} p50 {lat['p50_ms']:.3f} ms p90 {lat['p90_ms']:.3f} ms")
    return {"train_step_ms_p50": out["train_step_ms_p50"], "peak_gib": peak / 2**30,
            "pool_launches": pool, "evaluate_gap": gap, "quirk_err": err,
            **{f"serve_B{b}_{k}": v for b, lat in serves.items() for k, v in lat.items()}}


def by_supports(rows, b):
    """Phase 9c's S = 1 and S = 3 rows of a kernel for the kernels line:
    each S's largest error over both dtypes and its bf16 time at batch b
    (device ms where the rows have it)."""
    out = {}
    for s_count in (1, 3):
        mine = [r for r in rows if r["S"] == s_count]
        bf = [r for r in mine if r["dtype"] == "bfloat16" and r["B"] == b][0]
        out[f"max_abs_err_s{s_count}"] = max(r["max_abs_err"] for r in mine)
        out[f"ms_s{s_count}"] = bf["ms"]
        if "device_ms" in bf:
            out[f"device_ms_s{s_count}"] = bf["device_ms"]
    return out


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
    from multimodal_outage_tpu_torch.ops import dcrnn_stack as dsm
    from multimodal_outage_tpu_torch.ops import double_conv as dcm
    from multimodal_outage_tpu_torch.ops import gwnet_layer as glm
    from multimodal_outage_tpu_torch.ops import gwnet_stack as gsm
    from multimodal_outage_tpu_torch.ops import max_pool as mp

    t_start = time.perf_counter()
    smi = card()
    log(f"phase 1: {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    for name, (secs, report) in built.items():
        log(f"phase 2: built {name} in {secs:.1f} s")
        for line in report.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem")):
                log(f"  {line.strip()}")
    log(f"phase 2: build {time.perf_counter() - t0:.1f} s")

    # exact float32 plain references: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    dc_rows, f1 = check_double_conv(torch, F, dcm, gen)
    st_rows, f2 = check_gwnet_stack(torch, gsm, weights, ModelConfig(), gen)
    mp_rows, f3 = check_max_pool(torch, F, mp, gen)
    gl_rows, f3d = check_gwnet_layer(torch, glm, gsm, weights, ModelConfig(), gen)
    ds_rows, f3e = check_dcrnn_stack(torch, dsm, weights, gen)
    if f1 or f2 or f3 or f3d or f3e:
        raise RuntimeError("phase 3: kernel disagrees with its plain version:\n"
                           + "\n".join(f1 + f2 + f3 + f3d + f3e))
    log("phase 3: every kernel agrees with its plain version at every shape")

    with tempfile.TemporaryDirectory() as workdir:
        store_dir, runs, launches = serve_end_to_end(torch, cli, dcm, gsm, workdir)
        f4 = engine_vs_plain(torch, store_dir)
        if f4:
            raise RuntimeError("phase 4: engine disagrees with the plain engine:\n" + "\n".join(f4))
        for b, out in runs.items():
            log(f"phase 4: serve B={b} metrics {json.dumps(out['metrics'])} "
                f"p50 {out['latency']['p50_ms']:.3f} ms p90 {out['latency']['p90_ms']:.3f} ms")
        dcrnn_runs, dcrnn_launches = serve_dcrnn_end_to_end(torch, cli, dcm, dsm, gsm, store_dir)
        f4d = engine_vs_plain(torch, store_dir, st_gnn="dcrnn")
        f4d += engine_vs_plain(torch, store_dir, gwnet_stack=False, gwnet_pallas=True)
        if f4d:
            raise RuntimeError("phase 4d: engine disagrees with the plain engine:\n"
                               + "\n".join(f4d))
        for b, out in dcrnn_runs.items():
            log(f"phase 4c: serve --st_gnn dcrnn B={b} metrics {json.dumps(out['metrics'])} "
                f"p50 {out['latency']['p50_ms']:.3f} ms p90 {out['latency']['p90_ms']:.3f} ms")
        train_store, trained, pool_launches, _ = train_end_to_end(torch, cli, mp, workdir)
        f5 = step_vs_plain(torch, train_store)
        if f5:
            raise RuntimeError("phase 5b: kernel step disagrees with the plain step:\n"
                               + "\n".join(f5))
        _, layer_launches = train_gwnet_layer_end_to_end(torch, glm, mp, train_store, workdir)
        p7 = checkpoint_end_to_end(torch, cli, dcm, dsm, gsm, mp, workdir, store_dir,
                                   train_store, trained, dcrnn_runs[1])
        log(f"phase 7: {json.dumps(p7)}")
        p8 = train_dcrnn_end_to_end(torch, cli, dcm, dsm, gsm, mp, workdir, train_store)
        log(f"phase 8: {json.dumps(p8)}")
        gl9_rows, f9 = check_gwnet_layer_supports(torch, glm, gsm, weights, gen)
        if f9:
            raise RuntimeError("phase 9c: kernel 3 disagrees with its plain version:\n"
                               + "\n".join(f9))
        p9a = resume_end_to_end(torch, cli, mp, workdir, train_store)
        p9b = date2vec_end_to_end(torch, cli, workdir, train_store)
        st9_rows, p9c = graph_flags_end_to_end(torch, cli, dcm, dsm, gsm, weights, store_dir,
                                               workdir, dcrnn_runs[1], gen)
        log(f"phase 9: {json.dumps({**p9a, **p9b, **p9c})}")
        p10 = nonfused_gwnet_end_to_end(torch, cli, dcm, gsm, glm, mp, weights, workdir,
                                        store_dir, train_store, gen)
        log(f"phase 10: {json.dumps(p10)}")

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
            **by_supports(st9_rows, 1),
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
    main_gl = [r for r in gl_rows if r["dtype"] == "bfloat16" and r["B"] == 8][0]
    main_ds = [r for r in ds_rows if r["dtype"] == "bfloat16" and r["B"] == 1][0]
    # gwnet_layer also gives its device time: one call's host enqueue is
    # longer than the kernel, so its back-to-back `ms` times the host
    for name, src, replaces, n, row, extra in (
        ("gwnet_layer", "gwnet_layer.cu", "gwnet_pallas.py:187", layer_launches, main_gl,
         {"device_ms": main_gl["device_ms"], **by_supports(gl9_rows, 8)}),
        ("dcrnn_stack", "dcrnn_stack.cu", "dcrnn_stack_pallas.py:169", dcrnn_launches, main_ds,
         {}),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"multimodal_outage_tpu_torch/csrc/{src}",
            "replaces": f"multimodal_outage_tpu/ops/{replaces}",
            "launches": n, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, **extra,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s; kernel times are bf16: one B=1 "
        "serving forward's calls (double_conv: the sum of its 9 shapes), one B=8 "
        "train step's pools (max_pool: the sum of its 4 shapes), one B=8 call of the "
        "per-layer kernel (gwnet_layer: 8 per step; ms by back-to-back events, host "
        "enqueue included; device_ms the kernel's own time from torch.profiler) "
        "and one B=1 DCRNN forward")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
