#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (multimodal_outage_tpu_torch) on
one NVIDIA card: builds the hand-written kernels from csrc/, holds each
against its plain PyTorch version at every shape the serving and training
paths give it (kernel 1 also in its up form at the four up levels),
serves a held-out hurricane end to end at full width
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
and reference_view_quirk through kernel 3), trains with gradient
accumulation and remat (phase 11: `train --grad_accum 2` at B=16, `train
--grad_accum auto` at B=32, which must run out of memory one-shot and
fall back to 2 microbatches, each remat scope at B=16, and float32
accumulating and remat steps against the plain steps), runs the data path
(phase 12: a 4.2 GB store past the device budget trained, evaluated and
served through the host prefetch path, its batches and a float32 step
bitwise the device path's, the transform hooks on every stream, and
`ingest` / `ingest-monthly` on the card against the CPU), imports a
reference Lightning checkpoint (phase 13: `import-torch` of a full-width
`.ckpt` and Date2Vec `.pth`, its leaves bitwise the source, `evaluate`
and `serve` of it equal to the same variables written directly, `train
--resume` from it, and the DCRNN refusal), runs the `bench` configs
(phase 14: every ported config of benchmarks.py through run_benchmark,
`bench --config e2e_train` through the CLI, two batch_scaling cells in
processes of their own, and the A/B pairs that put a kernel against its
module held to the port's bars), runs the mesh (phase 15: ranks sharing
the card over gloo; float32 steps on 2x1x1, 1x2x1 and 1x1x7 and the
padded ragged tail against the one-rank step, kernel 3 under a mesh,
bf16 `train` on each mesh with a resume across meshes, `evaluate` and
`serve` on 2x1x1 against one device, `bench sharded_pipeline` /
`serving_sharded` on an NCCL group of one, two host processes through
`--coordinator_address`), and checks that each path went through its
kernels.

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

from multimodal_outage_tpu_torch.benchmarks import _PEAKS  # noqa: E402

# H100 SXM data sheet, one table for this script and `bench --config roofline`
H100_BF16_OPS, H100_BYTES_PER_S = _PEAKS["h100 80gb hbm3"]  # dense bf16 tensor; HBM3
PEAK_OPS = {"bfloat16": H100_BF16_OPS, "float32": 67e12}  # fp32: CUDA cores
M_B1 = 67 * 7  # folded images of one request: 67 counties × 7 days
# (H, Cin, C) of the 9 DoubleConvs of one forward, contraction then expansion
DOUBLE_CONV_SHAPES = (
    (128, 1, 4), (64, 4, 8), (32, 8, 16), (16, 16, 32), (8, 32, 64),
    (16, 64, 32), (32, 32, 16), (64, 16, 8), (128, 8, 4),
)
# (H, Cl, C) of the 4 up levels of one forward: skip [M, H, H, C],
# low-resolution map [M, H/2, H/2, Cl]; the bf16 engine runs each as kernel
# 1's up form (ConvTranspose 2×2 + concat + DoubleConv 2C → C, one launch)
UP_SHAPES = ((16, 64, 32), (32, 32, 16), (64, 16, 8), (128, 8, 4))
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
# phase 11b: one float32 B=8 step as 2 microbatches of 4 against the
# one-shot step, deterministic cuDNN, no TF32, dropout off. The two differ
# only in summation order: each weight gradient is one reduction over
# 8·67·7 images against two over 4·67·7 added, and the serial BatchNorm
# EMA is applied in two parts. The loss (relative) and each BN
# running-stat buffer (over its largest entry; the EMA's rounding scales
# with the buffer) are held within ACCUM_RTOL of the one-shot step's. The
# gradients are not held to each other: a 128² level's weight gradient
# reduces ~6e7 products in float32, and cuDNN's algorithms for a batch of
# 8 and for one of 4 round it differently (measured on an H100: the
# one-shot step with cuDNN against the same step with cuDNN off, up to
# 2.9e-3 of a leaf's largest entry). So against the same one-shot step
# with cuDNN off (native convolutions, float32 GEMMs), the accumulating
# step may be at most ACCUM_RATIO times as far off as the one-shot step,
# plus the CPU test's bars as a floor (tests/test_torch_port_accum_remat.py:
# each gradient leaf within ACCUM_GRAD_RTOL of its largest entry, or of
# 1e-3 of the largest gradient of all for leaves whose true gradient is 0;
# parameters within 1e-6 where the gradient is above that bar, since
# Adam's first update is lr·g/(|g|+ε) and an entry whose gradient is
# summation noise moves by ±lr with its sign).
ACCUM_RATIO = 2.0
ACCUM_RTOL, ACCUM_GRAD_RTOL = 1e-5, 1e-4
# phase 11d: a remat step recomputes the same arithmetic on the same
# inputs (deterministic cuDNN picks the same algorithm for the same
# shape), so a float32 B=2 step per scope is held to the plain step at
# REMAT_RTOL, a few float32 ulps; any larger gap is a remat fault
REMAT_RTOL = 1e-6
LR = 1e-3
# phase 12a: all three storms at ±160 days: 963 dates, 4,228 MB in
# float32, past DataConfig's default device_store_budget_mb (4,096)
BIG_MARGIN = 160
# phase 12e: the raw tree's ±8 days around one storm (17 dates); ingest on
# the card against ingest on the CPU: the same antialiased resize, summed
# in another order
INGEST_MARGIN = 8
INGEST_ATOL, INGEST_RTOL = 1e-4, 1e-5
# phase 14: the `bench` configs (multimodal_outage_tpu_torch/benchmarks.py)
# run through run_benchmark at a small --steps; e2e_train through the CLI
# in a subprocess; batch_scaling's b=8 plain cell and b=32 plain (the cell
# that does not fit one-shot) each in its own process
BENCH_STEPS = {
    "dcrnn": 3, "unet_train": 3, "serving": 6, "fusion_inference": 6, "unet_cpu_b4": 3,
    "gwnet_forecast": 6, "gwnet_stack": 10, "dcrnn_stack": 10, "pool_pallas": 2,
    "remat_conv": 2, "roofline": 3, "serving_roofline": 5, "fused_stack": 3,
    "multimodal_fusion": 3, "grad_accum_sync": 2, "layout_matrix": 3, "conv_layout": 3,
}
# phase 15 (the mesh on one card): ranks share cuda:0 over gloo
# (MULTIMODAL_OUTAGE_TORCH_VIRTUAL_DEVICES). A float32 B=8 step on each
# mesh, deterministic cuDNN, no TF32, against the one-rank step on the
# same batch: the loss within MESH_LOSS_RTOL (JAX's 1e-5 for metrics,
# tests/test_sharding.py:317), each BatchNorm running-stat buffer within
# MESH_STAT_RTOL of its largest entry (JAX's 1e-4), each gradient leaf
# (the data × time sum, before Adam) within MESH_GRAD_RTOL of its largest
# entry (or of 1e-3 of the largest gradient of all, for leaves whose true
# gradient is 0), as tests/test_torch_port_cuda.py holds the 2-rank step,
# and the parameters after one Adam step within JAX's rtol 1e-2 / atol
# 5e-4 on at least MESH_PARAM_SHARE of all entries
# (tests/test_sharding.py:104-110). A mesh sums the gradient, on the time
# axis the BatchNorm moments and on the model axis the bottleneck's
# partial products, over the ranks in another order, and cuDNN runs a rank's 4 rows (or 1 frame) where one device runs 8: at full
# width that alone moves a weight gradient by ~3e-3 of its leaf (phase
# 11b's finding, and 15a's first reading: 2.3e-3 / 2.9e-3 / 2.9e-3 for
# 2x1x1 / 1x2x1 / 1x1x7), so these steps' gradients are held as phase
# 11b holds the accumulating step's: against the one-rank step with cuDNN
# off (native convolutions, float32 GEMMs), the mesh step may be at most
# MESH_GRAD_RATIO times as far off as the one-rank step with cuDNN, plus
# MESH_GRAD_RTOL. The padded, masked ragged tail (B=3 → 8, dropout off: a
# padded step draws masks for 8 rows) is held to the plain B=3 step the
# same way. The remat step (remat_scope all, 1x1x7: its recompute runs on
# autograd's device thread) is held to the same mesh's step without
# remat, and kernel 3 on 2x1x1 to the plain layer on 2x1x1, at the bars
# themselves: the same sums in the same order.
MESH_LOSS_RTOL, MESH_STAT_RTOL, MESH_GRAD_RTOL, MESH_PARAM_SHARE = 1e-5, 1e-4, 1e-4, 0.99
MESH_GRAD_RATIO = ACCUM_RATIO
# phase 15c: evaluate on 2x1x1 against phase 7's one-device evaluate: the
# same module at the same dtype, a rank's eval forward taking 4 rows where
# one device takes 8 (cuDNN may round bf16 differently; 4.1e-7 measured on
# the H100 80GB HBM3 at 700 W), so 1e-5; serve (the module path on a
# mesh) against phase 7's serve (the folded-BN engine) at phase 7b's
# SERVE_RTOL
MESH_EVAL_RTOL = 1e-5
_THROUGHPUT = {"step_seconds", "tiles_per_step", "tiles_per_sec", "batch", "image_size"}
_ROOF = {"device_kind", "gflops_per_step", "gbytes_per_step", "measured_ms",
         "tensor_floor_ms", "hbm_floor_ms", "bound", "arithmetic_intensity"}
# the detail keys of each config on the card (the JAX package's keys on a
# TPU, under the port's names: xla/flax → module, mxu → tensor)
BENCH_DETAIL = {
    "dcrnn": _THROUGHPUT | {"forecast_latency_ms"},
    "unet_train": _THROUGHPUT,
    "serving": {"module_eval_ms", "speedup_vs_module", "b16_throughput_tiles_per_sec"},
    "fusion_inference": set(),
    "unet_cpu_b4": _THROUGHPUT,
    "gwnet_forecast": {f"b{b}_{k}" for b in (1, 16) for k in ("module", "pallas")},
    "gwnet_stack": {f"b{b}_{k}_{w}" for b in (1, 16) for k in ("module", "stack")
                    for w in ("ms", "device_us")},
    "dcrnn_stack": {f"b{b}_{k}_{w}" for b in (1, 16) for k in ("module", "stack")
                    for w in ("ms", "device_us")},
    "pool_pallas": {"iso_reduce_window", "iso_pallas", "reduce_window", "pallas"},
    "remat_conv": {"base", "remat_conv"},
    "roofline": _ROOF,
    "serving_roofline": _ROOF | {"tiles_per_sec"},
    "fused_stack": _THROUGHPUT,
    "multimodal_fusion": _THROUGHPUT,
    "grad_accum_sync": {"pipelined_tiles_per_sec", "synced_tiles_per_sec",
                        "pipelined_step_ms", "synced_step_ms"},
    "layout_matrix": {"base", "pool", "stem", "pool_stem", "base2", "stem8"},
    "conv_layout": {"nhwc", "nchw", "nchw_xpose"},
}


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
    """Phase 3a: the DoubleConv kernel at the 9 shapes of a B=1 forward
    (the bf16 engine runs the last 4 as the up form, below; float32 and
    training run all 9 in this form), then its up form."""
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
                "form": "plain", "dtype": dn, "M": M_B1, "H": h, "Cin": cin, "C": c,
                "max_abs_err": err,
                "ok": ok, "check": note, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                "vs_library": t_k / t_l, "smem_bytes": smem, "blocks": blocks,
                "bytes": nbytes, "flop": nops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            log("double_conv", json.dumps(row))
            rows.append(row)
            if not ok:
                failures.append(f"double_conv {dn} H={h} Cin={cin} C={c}: max err {err}")
    up_rows, up_failures = check_up_double_conv(torch, F, dcm, gen)
    rows, failures = rows + up_rows, failures + up_failures
    slow = [f"{r['form']} {r['H']}² {r['Cin']}→{r['C']} M={r['M']} ({r['vs_library']:.2f}×)"
            for r in rows if r["dtype"] == "bfloat16" and r["vs_library"] > 1]
    log(f"phase 3a: bf16 shapes where the kernel is slower than cuDNN: {', '.join(slow) or 'none'}")
    return rows, failures


def check_up_double_conv(torch, F, dcm, gen):
    """Phase 3a, the up form: kernel 1's up form at the 4 up levels of a
    B=1 and a B=16 forward, bf16, against up_double_conv_reference
    (ConvTranspose → concat → the plain DoubleConv) on the same inputs,
    both held to the float32 computation by the bf16 bar. The ConvTranspose
    bias is large (~4), so a bias leaking into the concat's SAME padding
    fails. Library yardstick: cuDNN's ConvTranspose, torch.cat, then cuDNN
    conv + affine + ReLU twice."""
    rows, failures = [], []
    dtype, dev = torch.bfloat16, "cuda"
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    for m in (M_B1, 16 * M_B1):
        for h, cl, c in UP_SHAPES:
            cin = 2 * c
            skip = torch.relu(randn(m, h, h, c)).to(dtype)
            low = torch.relu(randn(m, h // 2, h // 2, cl)).to(dtype)
            wt = (randn(cl, c, 2, 2) * cl ** -0.5).to(dtype)
            bt = (4.0 + 0.5 * randn(c)).to(dtype)
            w1 = (randn(3, 3, cin, c) * (2.0 / (9 * cin)) ** 0.5).to(dtype)
            w2 = (randn(3, 3, c, c) * (2.0 / (9 * c)) ** 0.5).to(dtype)
            s1, s2 = (0.5 + torch.rand(c, generator=gen, device=dev) for _ in range(2))
            b1, b2 = (0.1 * randn(c) for _ in range(2))
            args = (skip, low, wt, bt, w1, s1, b1, w2, s2, b2)
            before = (dcm.fused_double_conv.launches, dcm.fused_double_conv.up_launches)
            got = dcm.fused_up_double_conv(*args)
            grew = (dcm.fused_double_conv.launches - before[0],
                    dcm.fused_double_conv.up_launches - before[1])
            want = dcm.up_double_conv_reference(*args)
            truth = dcm.up_double_conv_reference(*(a.float() for a in args))
            torch.cuda.synchronize()
            err, ok, note = compare(got, want, truth)
            ok = ok and grew == (1, 1)
            del truth
            k1 = w1.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            v = lambda t: t.to(dtype).view(1, -1, 1, 1)

            def library():
                y = F.conv_transpose2d(low.permute(0, 3, 1, 2), wt, bt, stride=2)
                x = torch.cat([skip.permute(0, 3, 1, 2), y], 1)
                y = torch.relu(F.conv2d(x, k1, padding=1) * v(s1) + v(b1))
                return torch.relu(F.conv2d(y, k2, padding=1) * v(s2) + v(b2))

            reps = 5 if h >= 64 else 10
            t_k = events_ms(lambda: dcm.fused_up_double_conv(*args), reps)
            t_p = events_ms(lambda: dcm.up_double_conv_reference(*args), reps)
            t_l = events_ms(library, reps)
            nbytes = dcm.up_min_bytes(m, h, h, c, cl, c, skip.element_size())
            nops = dcm.up_flops(m, h, h, c, cl, c)
            t_bytes, t_ops = 1e3 * nbytes / H100_BYTES_PER_S, 1e3 * nops / PEAK_OPS["bfloat16"]
            plan = dcm.plan_bf16(m, h, h, cin, c, cl)
            row = {
                "form": "up", "dtype": "bfloat16", "M": m, "H": h, "Cl": cl, "Cin": cin, "C": c,
                "max_abs_err": err, "ok": ok, "check": note, "launches": grew, "ms": t_k,
                "plain_ms": t_p, "library_ms": t_l, "vs_library": t_k / t_l,
                "tile": [plan.th, plan.tw], "smem_bytes": plan.smem, "bytes": nbytes,
                "flop": nops, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            log("double_conv", json.dumps(row))
            rows.append(row)
            if not ok:
                failures.append(f"double_conv up form H={h} Cl={cl} C={c} M={m}: max err {err} "
                                f"{note}, launches {grew}")
            del skip, low, got, want
            torch.cuda.empty_cache()
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


def check_up_launches(dcm, f, label, since=0):
    """Every up level of a bf16 forward at 128² runs kernel 1's up form:
    fused_double_conv.up_launches grew by 4 a forward since `since`."""
    up = dcm.fused_double_conv.up_launches - since
    log(f"{label}: {f} forwards, {up} up-form launches")
    if up != 4 * f:
        raise RuntimeError(f"{label}: {f} forwards launched the up form {up} times, "
                           f"expected {4 * f}")
    return up


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
        dcm.fused_double_conv.up_launches = 0
        out = cli.run(common + ["--batch_size", str(b), "--max_batches", str(k)])
        torch.cuda.synchronize()
        grew = tuple(c.launches for c in counters)
        f = out["forwards"]
        log(f"serve --st_gnn dcrnn B={b}: {json.dumps(out)} launches (double_conv, "
            f"dcrnn_stack, gwnet_stack) {grew}")
        if grew != (9 * f, f, 0):
            raise RuntimeError(f"serve dcrnn B={b}: {f} forwards launched {grew}, "
                               f"expected {(9 * f, f, 0)}")
        check_up_launches(dcm, f, f"serve dcrnn B={b}")
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
    dcm.fused_double_conv.launches = dcm.fused_double_conv.up_launches = 0
    gsm.gwnet_stack_forward.launches = 0
    for b, k in ((1, 3), (16, 3)):
        before = (dcm.fused_double_conv.launches, gsm.gwnet_stack_forward.launches)
        up0 = dcm.fused_double_conv.up_launches
        out = cli.run(common + ["--batch_size", str(b), "--max_batches", str(k)])
        torch.cuda.synchronize()
        f = out["forwards"]
        grew = (dcm.fused_double_conv.launches - before[0],
                gsm.gwnet_stack_forward.launches - before[1])
        log(f"serve B={b}: {json.dumps(out)} launches {grew}")
        if grew != (9 * f, f):
            raise RuntimeError(f"serve B={b}: {f} forwards launched {grew}, expected {(9 * f, f)}")
        check_up_launches(dcm, f, f"serve B={b}", since=up0)
        if not all(math.isfinite(v) for v in out["metrics"].values()):
            raise RuntimeError(f"serve B={b}: non-finite metrics {out['metrics']}")
        runs[b] = out
    launches = {"double_conv": dcm.fused_double_conv.launches,
                "double_conv_up": dcm.fused_double_conv.up_launches,
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


def train_batch(torch, store_dir, n=8):
    """(store, first n train windows of phase 5's store on the card)."""
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
    return store, pipe.batch(ds, list(range(n)))


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
    dcm.fused_double_conv.up_launches = 0
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
    check_up_launches(dcm, f, "phase 7b")
    if max(gaps.values()) > SERVE_RTOL:
        raise RuntimeError(f"phase 7b: serve {sv['metrics']} vs evaluate {ev['metrics']}")

    d_ckpt = os.path.join(workdir, "dcrnn_checkpoints")
    tree = weights.init_variables(ModelConfig(st_gnn="dcrnn"), 7, 67, seed=0)
    CheckpointManager(d_ckpt).save(0, tree, metrics={"val_loss": 0.0})
    counters = (dcm.fused_double_conv, dsm.dcrnn_stack_forward, gsm.gwnet_stack_forward)
    for c in counters:
        c.launches = 0
    dcm.fused_double_conv.up_launches = 0
    sd = cli.run(["serve", "--checkpoint_path", d_ckpt, "--st_gnn", "dcrnn", "--data_dir",
                  store_dir, "--case", "michael", "--dataset_range", "24", "--batch_size", "1",
                  "--max_batches", "3", "--latency_stats"])
    torch.cuda.synchronize()
    grew, f = tuple(c.launches for c in counters), sd["forwards"]
    log(f"phase 7c: serve --checkpoint_path --st_gnn dcrnn B=1 {json.dumps(sd)} launches "
        f"(double_conv, dcrnn_stack, gwnet_stack) {grew}")
    if grew != (9 * f, f, 0):
        raise RuntimeError(f"phase 7c: {f} forwards launched {grew}, expected {(9 * f, f, 0)}")
    check_up_launches(dcm, f, "phase 7c")
    if sd["metrics"] != dcrnn_b1["metrics"]:
        raise RuntimeError(f"phase 7c: {sd['metrics']} differ from --seed 0's {dcrnn_b1['metrics']}")
    for name, out in (("7b serve gwnet B=8", sv), ("7c serve dcrnn B=1", sd)):
        log(f"phase {name} from a checkpoint: p50 {out['latency']['p50_ms']:.3f} ms "
            f"p90 {out['latency']['p90_ms']:.3f} ms")
    return {"evaluate_s": wall, "evaluate_forwards": ev["forwards"], "round_trip_gap": gap,
            "serve_gaps": gaps, "evaluate_metrics": ev["metrics"], "serve_metrics": sv["metrics"]}


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
    dcm.fused_double_conv.up_launches = 0
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
    check_up_launches(dcm, f, "phase 8d")
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
            dcm.fused_double_conv.up_launches = 0
            out = cli.run(common + flags + ["--batch_size", str(b), "--max_batches", str(k)])
            torch.cuda.synchronize()
            grew, f = (dcm.fused_double_conv.launches, gsm.gwnet_stack_forward.launches), \
                out["forwards"]
            log(f"phase 9c: serve S={s_count} {' '.join(flags)} B={b}: {json.dumps(out)} "
                f"launches (double_conv, gwnet_stack) {grew}")
            if grew != (9 * f, f):
                raise RuntimeError(f"phase 9c S={s_count} B={b}: {f} forwards launched {grew}")
            check_up_launches(dcm, f, f"phase 9c S={s_count} B={b}")
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
    dcm.fused_double_conv.up_launches = 0
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
    check_up_launches(dcm, f, "phase 9c dcrnn --adjacency")
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
        dcm.fused_double_conv.up_launches = 0
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
        check_up_launches(dcm, f, f"phase 10c B={b}")
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


def _step_state(torch, model, loss):
    """(loss, gradients, parameters, buffers) of a model after a step, on
    the host in float32."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).float().cpu()
             for k, p in model.named_parameters()}
    params = {k: p.detach().float().cpu() for k, p in model.named_parameters()}
    stats = {k: b.float().cpu() for k, b in model.named_buffers()}
    return float(loss), grads, params, stats


def _step_gaps(a, b, grad_rtol):
    """Gaps of step a to the reference step b (each _step_state): relative
    loss; the largest gradient gap over each leaf's largest entry (floor
    1e-3 of the largest gradient of all); the largest BN running-stat gap
    over its buffer's largest entry; the largest parameter gap where b's gradient is above grad_rtol
    of that scale ("params"), and anywhere ("params_any")."""
    (la, ga, pa, sa), (lb, gb, pb, sb) = a, b
    g_all = max(float(v.abs().max()) for v in gb.values())
    gaps = {"loss": abs(la - lb) / abs(lb), "grad": 0.0, "bn_stats": 0.0, "params": 0.0,
            "params_any": 0.0}
    for k in gb:
        scale = max(float(gb[k].abs().max()), 1e-3 * g_all)
        gaps["grad"] = max(gaps["grad"], float((ga[k] - gb[k]).abs().max()) / scale)
        d = (pa[k] - pb[k]).abs()
        signal = gb[k].abs() > grad_rtol * scale
        if signal.any():
            gaps["params"] = max(gaps["params"], float(d[signal].max()))
        gaps["params_any"] = max(gaps["params_any"], float(d.max()))
    for k in sb:
        gaps["bn_stats"] = max(gaps["bn_stats"], _rel_gap(sa[k], sb[k]))
    return gaps


def _gaps_ok(gaps, rtol):
    return (gaps["loss"] <= rtol and gaps["bn_stats"] <= rtol and gaps["grad"] <= rtol
            and gaps["params"] <= 1e-6 and gaps["params_any"] <= 2 * LR + 1e-6)


def accum_remat_end_to_end(torch, cli, mp, workdir, train_store):
    """Phase 11: gradient accumulation and remat at full width (bf16,
    --pool pallas, phase 5's store), the launch counters set to 0 just
    before each run and read just after. (a) `train --batch_size 16
    --grad_accum 2 --epochs 2`: pool launches 4 per microbatch forward and
    backward plus 4 per eval batch; step p50 and peak. (b) one float32 B=8
    step of make_accum_train_step(model, 2) against the one-shot step,
    and both against the one-shot step with cuDNN off.
    (d) one fixed B=16 batch through make_train_step for each remat scope
    (none, stem, all, conv), 1 warm-up and 5 timed steps: step p50, peak
    memory, pool launches per step (forward 4 / 5 / 8 / 8, backward 4),
    peaks all < stem < none and conv < none; then a float32 B=2 step per
    scope against none. (e) `train --remat --remat_scope stem --batch_size
    16`. (c, last) `train --batch_size 32 --grad_accum auto --epochs 4`:
    the one-shot step must run out of memory at the first step and fall
    back to 2 microbatches of 16 (the stderr line), then finish; the peak
    after the fallback, and the p50 of its 2-microbatch steps after the
    first, from CUDA events around each call."""
    import contextlib
    import gc
    import io

    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.data.dataset import batch_indices
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.train import loop
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import make_accum_train_step, make_train_step

    common = ["train", "--data_dir", train_store, "--case", "michael", "--dataset_range",
              str(TRAIN_MARGIN), "--seed", "0", "--pool", "pallas"]
    n_train = len(loop.prepare_datasets(cli._config(cli._parser().parse_args(common)),
                                        "michael")[1])
    log(f"phase 11: phase 5's store holds {n_train} train windows")
    if n_train < 32:
        raise RuntimeError(f"phase 11: {n_train} train windows, 32 needed for B=32")
    out = {}

    def counters():
        return (mp.max_pool_forward.launches, mp.max_pool_backward.launches)

    def zero():
        mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0

    def train(argv):
        cwd = os.getcwd()
        os.chdir(workdir)  # the run directory is ./logs/<job_id>
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero()
            t0 = time.perf_counter()
            res = cli.run(common + argv)
            torch.cuda.synchronize()
            return res, counters(), torch.cuda.max_memory_allocated(), time.perf_counter() - t0
        finally:
            os.chdir(cwd)

    def finite(res, label):
        finals = [v for k, v in res.items() if k.startswith(("val_", "test_"))]
        if len(finals) != 8 or not all(math.isfinite(v) for v in finals):
            raise RuntimeError(f"phase {label}: non-finite or missing final metrics {res}")

    # (a) --grad_accum 2 at B=16: microbatches of 8
    epochs = 2
    res, pool, peak, wall = train(["--batch_size", "16", "--grad_accum", "2", "--epochs",
                                   str(epochs), "--job_id", "accum16"])
    sizes = [len(b) for b in batch_indices(n_train, 16, False, 0)]
    micro = epochs * sum(loop._accum_split_count(b, 8) for b in sizes)
    evals = res["eval_forwards"]
    want = (4 * micro + 4 * evals, 4 * micro)
    log(f"phase 11a: train --batch_size 16 --grad_accum 2 {json.dumps(res)}; {wall:.3f} s wall")
    log(f"phase 11a: batches {sizes} per epoch, {micro} microbatches in {res['train_steps']} "
        f"steps (8 fwd + 8 bwd launches per 2-microbatch step), {evals} eval forwards: pool "
        f"launches (fwd, bwd) {pool}, expected {want}; step p50 "
        f"{res['train_step_ms_p50']:.3f} ms (CUDA events, after the first step); peak memory "
        f"{peak / 2**30:.2f} GiB")
    if pool != want or res["train_steps"] != epochs * len(sizes):
        raise RuntimeError(f"phase 11a: pool launches {pool}, expected {want}")
    finite(res, "11a")
    out["a"] = {"step_ms_p50": res["train_step_ms_p50"], "peak_gib": peak / 2**30,
                "pool_launches": pool}

    # (b) float32 B=8: 2 microbatches of 4 against the one-shot step
    store, batch8 = train_batch(torch, train_store, 8)
    sup = torch.from_numpy(model_supports(ModelConfig(), 67, store.county_names)).cuda()
    var = weights.init_variables(ModelConfig(), 7, 67, seed=3)

    def one_step(cfg, batch, make):
        model = weights.load_variables(build_model(cfg, 7, 67, 128), var).cuda()
        m = make(model)(create_train_state(model), batch, sup, LR, 0)
        return _step_state(torch, model, m["loss"])

    # dropout off: the microbatches draw other masks than the one-shot step
    f32 = ModelConfig(compute_dtype="float32", pool="pallas", encoder_dropout=0.0,
                      gwnet=GWNetConfig(dropout=0.0))
    torch.backends.cudnn.deterministic = True
    try:
        accum = one_step(f32, batch8, lambda m: make_accum_train_step(m, 2))
        whole = one_step(f32, batch8, make_train_step)
        torch.backends.cudnn.enabled = False
        ref = one_step(f32, batch8, make_train_step)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.enabled = True
    gaps = _step_gaps(accum, whole, ACCUM_GRAD_RTOL)
    e_acc, e_one = (_step_gaps(st, ref, ACCUM_GRAD_RTOL) for st in (accum, whole))
    ok = (gaps["loss"] <= ACCUM_RTOL and gaps["bn_stats"] <= ACCUM_RTOL
          and e_acc["grad"] <= ACCUM_RATIO * e_one["grad"] + ACCUM_GRAD_RTOL
          and e_acc["params"] <= ACCUM_RATIO * e_one["params"] + 1e-6
          and gaps["params_any"] <= 2 * LR + 1e-6)
    log(f"phase 11b: float32 B=8 step, 2 microbatches of 4 vs one-shot: gaps {json.dumps(gaps)}; "
        f"against the one-shot step without cuDNN: accumulating {json.dumps(e_acc)}, one-shot "
        f"{json.dumps(e_one)} (bars: loss, BN stats {ACCUM_RTOL}; grad and params at most "
        f"{ACCUM_RATIO}× the one-shot's + {ACCUM_GRAD_RTOL} / 1e-6), ok {ok}")
    if not ok:
        raise RuntimeError(f"phase 11b: the accumulating step is off the one-shot step: {gaps}")
    out["b"] = {"gaps": gaps, "grad_vs_native": (e_acc["grad"], e_one["grad"]),
                "params_vs_native": (e_acc["params"], e_one["params"])}

    # (d) each remat scope on one B=16 batch through make_train_step
    del batch8, accum, whole
    _, batch16 = train_batch(torch, train_store, 16)
    scopes = {}
    for scope in ("none", "stem", "all", "conv"):
        cfg = ModelConfig(pool="pallas", remat=scope != "none",
                          remat_scope="all" if scope == "none" else scope)
        model = weights.load_variables(build_model(cfg, 7, 67, 128), var).cuda()
        state, step = create_train_state(model), make_train_step(model)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch16, sup, LR, 0)  # warm-up
        torch.cuda.synchronize()
        zero()
        times = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            step(state, batch16, sup, LR, 0)
            ev[1].record()
            times.append(ev)
        torch.cuda.synchronize()
        fwd, bwd = counters()
        scopes[scope] = {
            "step_ms_p50": sorted(a.elapsed_time(b) for a, b in times)[2],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "pool_per_step": (fwd / 5, bwd / 5),
        }
        del model, state, step
        gc.collect()
        log(f"phase 11d: remat {scope} B=16 bf16: {json.dumps(scopes[scope])}")
    want_fwd = {"none": 4, "stem": 5, "all": 8, "conv": 8}
    bad = [s for s, r in scopes.items() if r["pool_per_step"] != (want_fwd[s], 4)]
    pk = {s: r["peak_gib"] for s, r in scopes.items()}
    order = pk["all"] < pk["stem"] < pk["none"] and pk["conv"] < pk["none"]
    log(f"phase 11d: pool launches per step as expected (fwd 4/5/8/8, bwd 4) {not bad}; peaks "
        f"all < stem < none and conv < none {order}")
    if bad or not order:
        raise RuntimeError(f"phase 11d: launches off for {bad} or peaks out of order {pk}")
    del batch16
    _, batch2 = train_batch(torch, train_store, 2)
    torch.backends.cudnn.deterministic = True
    try:
        f32s = {s: one_step(ModelConfig(compute_dtype="float32", pool="pallas",
                                        remat=s != "none",
                                        remat_scope="all" if s == "none" else s),
                            batch2, make_train_step)
                for s in ("none", "stem", "all", "conv")}
    finally:
        torch.backends.cudnn.deterministic = False
    remat_gaps = {s: _step_gaps(f32s[s], f32s["none"], REMAT_RTOL) for s in ("stem", "all", "conv")}
    bad = [s for s, g in remat_gaps.items() if not _gaps_ok(g, REMAT_RTOL)]
    log(f"phase 11d: float32 B=2 step per scope vs no remat: gaps {json.dumps(remat_gaps)} "
        f"(bar {REMAT_RTOL}; params 1e-6), off {bad}")
    if bad:
        raise RuntimeError(f"phase 11d: a remat step is off the plain step: {bad}")
    out["d"] = {"scopes": scopes, "f32_gap": max(max(g.values()) for g in remat_gaps.values())}
    del batch2, f32s

    # (e) --remat --remat_scope stem at B=16 through the CLI
    res, pool, peak, wall = train(["--batch_size", "16", "--remat", "--remat_scope", "stem",
                                   "--epochs", "1", "--job_id", "remat_stem"])
    steps, evals = res["train_steps"], res["eval_forwards"]
    want = (5 * steps + 4 * evals, 4 * steps)
    log(f"phase 11e: train --remat --remat_scope stem --batch_size 16 {json.dumps(res)}; "
        f"{wall:.3f} s wall; pool launches {pool}, expected {want}; step p50 "
        f"{res['train_step_ms_p50']:.3f} ms; peak memory {peak / 2**30:.2f} GiB")
    if pool != want:
        raise RuntimeError(f"phase 11e: pool launches {pool}, expected {want}")
    finite(res, "11e")
    out["e"] = {"step_ms_p50": res["train_step_ms_p50"], "peak_gib": peak / 2**30,
                "pool_launches": pool}

    # (c) --grad_accum auto at B=32: the one-shot step must run out of memory
    seen = {"first_accum_step": None, "peak_reset": False, "events": []}
    real_make = loop.make_accum_train_step

    def make(model, accum, debug_nans=False):
        inner = real_make(model, accum, debug_nans)

        def timed(state, *args):
            if seen["first_accum_step"] is None:
                seen["first_accum_step"] = state.step
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()  # the settled peak from here
                seen["peak_reset"] = True
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            m = inner(state, *args)
            ev[1].record()
            seen["events"].append((accum, ev))
            return m

        return timed

    err = io.StringIO()
    loop.make_accum_train_step = make
    try:
        with contextlib.redirect_stderr(err):
            res, pool, peak, wall = train(["--batch_size", "32", "--grad_accum", "auto",
                                           "--epochs", "4", "--job_id", "auto32"])
    finally:
        loop.make_accum_train_step = real_make
    lines = [line for line in err.getvalue().splitlines() if "[auto grad_accum]" in line]
    sys.stderr.write(err.getvalue())
    want_line = "[auto grad_accum] step OOM'd; retrying with microbatch <= 16 (2 microbatches " \
                "at batch 32)"
    two = [ev for k, ev in seen["events"] if k == 2][1:]
    p50 = sorted(a.elapsed_time(b) for a, b in two)[len(two) // 2] if two else float("nan")
    log(f"phase 11c: train --batch_size 32 --grad_accum auto {json.dumps(res)}; {wall:.3f} s "
        f"wall; stderr {lines}; first accumulating step at global step "
        f"{seen['first_accum_step']}; split counts run {[k for k, _ in seen['events']]}; "
        f"2-microbatch step p50 {p50:.3f} ms (CUDA events, {len(two)} after the first); "
        f"settled peak {peak / 2**30:.2f} GiB; pool launches {pool}")
    if lines != [want_line]:
        raise RuntimeError(f"phase 11c: the one-shot B=32 step did not run out of memory once "
                           f"and fall back to 2 microbatches of 16: stderr lines {lines}")
    if seen["first_accum_step"] != 0 or not seen["peak_reset"] or len(two) < 2:
        raise RuntimeError(f"phase 11c: the fallback was not at the first step: {seen}")
    finite(res, "11c")
    out["c"] = {"step_ms_p50": p50, "settled_peak_gib": peak / 2**30, "pool_launches": pool,
                "fallback_at_step": seen["first_accum_step"] + 1}
    return out


class _Raster:
    """Stands in for the xarray DataArray of the reference's pickled daily
    rasters (phase 12e): data["Gap_Filled_DNB_BRDF-Corrected_NTL"].values."""

    def __init__(self, values):
        self.values = values


def _host_path_profile(torch, store, cases, steps=6):
    """Phase 12a: on the host path at full width, bf16, B=8 with the pool
    kernels: (a) the native gather of one batch's 8 × 14 frames into a
    pinned buffer, host clock, and its H2D copy alone, CUDA events, each
    the mean of 5 after one warm-up; (b) `steps` train steps fed by a
    depth-2 PrefetchIterator after two warm-up steps: their CUDA-event wall
    time per step and the profiler's device time of the kernels (both
    streams) and of the H2D copies, per step."""
    import numpy as np

    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import (
        DEFAULT_NTL_MEAN,
        DEFAULT_NTL_STD,
        ModelConfig,
    )
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.data.dataset import WindowDataset
    from multimodal_outage_tpu_torch.data.pipeline import PrefetchIterator
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import make_train_step

    ds = WindowDataset.from_case_study(store, cases, TRAIN_MARGIN, 7)
    batches = [np.arange(8 * k, 8 * k + 8) % len(ds) for k in range(steps + 2)]
    n = 8 * 14
    pinned = torch.empty((n,) + store.frames.shape[1:], dtype=torch.float32, pin_memory=True)
    dev = torch.empty_like(pinned, device="cuda")
    gather_s = []
    for b in batches[:6]:
        t0 = time.perf_counter()
        ds.gather_batch(b, out=pinned.numpy())
        gather_s.append(time.perf_counter() - t0)
    h2d = events_ms(lambda: dev.copy_(pinned, non_blocking=True), 5)
    del dev
    cfg = ModelConfig(pool="pallas")
    sup = torch.from_numpy(model_supports(cfg, 67, store.county_names)).cuda()
    model = weights.load_variables(build_model(cfg, 7, 67, 128),
                                   weights.init_variables(cfg, 7, 67, seed=3)).cuda()
    state, step = create_train_state(model), make_train_step(model)
    it = iter(PrefetchIterator(ds, iter(batches), DEFAULT_NTL_MEAN, DEFAULT_NTL_STD, 128,
                               torch.device("cuda"), depth=2))
    for _ in range(2):
        step(state, next(it), sup, LR, 0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start.record()
        for batch in it:
            step(state, batch, sup, LR, 0)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / steps
    dev_events = [ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
    copy_ms = sum(ev.time_range.elapsed_us() / 1e3 for ev in dev_events
                  if "Memcpy HtoD" in ev.name) / steps
    busy = sum(ev.time_range.elapsed_us() / 1e3 for ev in dev_events
               if "Memcpy" not in ev.name and "Memset" not in ev.name) / steps
    if not busy or not copy_ms:
        raise RuntimeError("phase 12a: the profiler caught no kernel or no H2D copy")
    return {"gather_ms": 1e3 * sum(gather_s[1:]) / len(gather_s[1:]), "h2d_ms": h2d,
            "batch_mb": pinned.numel() * 4 / 1e6, "step_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall, "h2d_in_step_ms": copy_ms}


def data_path_end_to_end(torch, cli, dcm, gsm, mp, workdir, train_store, trained):
    """Phase 12: the input paths and the ingest at full width, the launch
    counters set to 0 just before each run and read just after.
    (a) `synth --margin 160` (963 dates, 4,228 MB in float32, past the
    default 4,096 MB budget): the default Config takes the host path for it
    and the device path for phase 5's store; `train --pool pallas` on it at
    phase 5's settings (its window counts), through the host path (a
    PrefetchIterator per stream): pool launches (48, 20), the step p50
    beside phase 5's, peak memory, and _host_path_profile. (b) float32 on
    the same store, the device path forced (the store on the card): the
    first 3 train batches of each path bitwise equal, the host path's from
    a depth-2 prefetcher with a float32 train step between gets, and one
    step from each path's first batch with a bitwise-equal loss and
    gradients; in bf16 the host path's x is float32, the device path's
    bf16. (c) `evaluate --pool pallas` of (a)'s checkpoint through the host
    path: (a)'s test metrics exactly, 4 pool launches per batch; `serve
    --checkpoint_path` B=8: (9f, f) launches, within SERVE_RTOL of
    evaluate. (d) on phase 5's store, host path forced and device path: a
    frame transform (the default, then ×2) gives equal float32 batches on
    both paths; a counting transform runs once per batch on fit's train,
    val and final streams, predict and serve_eval. (e) `ingest` of a raw
    tree (67 counties × 17 dates around Michael, rasters of 90-260 ×
    140-310 with fill sentinels, .npy and pickled; an 18th date one county
    lacks) with --device cuda against --device cpu, then `ingest-monthly`
    and the store's stats."""
    import dataclasses
    from contextlib import closing

    import numpy as np

    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.checkpoint import restore_variables
    from multimodal_outage_tpu_torch.core.config import (
        DEFAULT_NTL_MEAN,
        DEFAULT_NTL_STD,
        Config,
        DataConfig,
        ModelConfig,
        TrainConfig,
    )
    from multimodal_outage_tpu_torch.core.registry import HURRICANES
    from multimodal_outage_tpu_torch.data import pipeline
    from multimodal_outage_tpu_torch.data.acquisition import NTL_VARIABLE
    from multimodal_outage_tpu_torch.data.adjacency import config_supports, model_supports
    from multimodal_outage_tpu_torch.data.stats import compute_mean_std
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.data.synthetic import generate_store
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.serving import ServingModel, serve_eval
    from multimodal_outage_tpu_torch.train import loop
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import make_train_step

    cuda = torch.device("cuda")
    out = {}
    free = shutil.disk_usage(workdir).free
    if free < 6e9:
        raise RuntimeError(f"phase 12: {free / 1e9:.1f} GB free in {workdir}; the store needs "
                           "4.2 GB and its copies")
    torch.cuda.empty_cache()

    # (a) a store past the budget, trained through the CLI's code path
    big = os.path.join(workdir, "big_store")
    t0 = time.perf_counter()
    generate_store(big, n_counties=67, image_size=128, margin=BIG_MARGIN, seed=12)
    store = load_store(big)
    size_mb = store.frames.size * 4 / 1e6
    small = load_store(train_store)
    choice = (loop.pipeline_choice(Config(), store), loop.pipeline_choice(Config(), small))
    log(f"phase 12a: synth --margin {BIG_MARGIN}: {store.n_dates} dates, {size_mb:.1f} MB "
        f"float32 in {time.perf_counter() - t0:.1f} s; default Config (budget "
        f"{DataConfig().device_store_budget_mb} MB) takes the {choice[0]} path for it and the "
        f"{choice[1]} path for phase 5's store ({small.frames.size * 4 / 1e6:.1f} MB)")
    if store.n_dates != 963 or choice != ("host", "device"):
        raise RuntimeError(f"phase 12a: {store.n_dates} dates, paths {choice}")
    made = []

    class Counting(pipeline.PrefetchIterator):
        def __init__(self, *a, **kw):
            made.append(kw.get("depth"))
            super().__init__(*a, **kw)

    cwd = os.getcwd()
    os.chdir(workdir)
    loop.PrefetchIterator = Counting
    try:
        torch.cuda.reset_peak_memory_stats()
        mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
        t0 = time.perf_counter()
        res = cli.run(["train", "--data_dir", big, "--case", "michael", "--dataset_range",
                       str(TRAIN_MARGIN), "--epochs", "1", "--batch_size", "8", "--seed", "0",
                       "--pool", "pallas", "--job_id", "big"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pool = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
        peak = torch.cuda.max_memory_allocated()
    finally:
        loop.PrefetchIterator = pipeline.PrefetchIterator
        os.chdir(cwd)
    steps, evals = res["train_steps"], res["eval_forwards"]
    want = (4 * steps + 4 * evals, 4 * steps)
    log(f"phase 12a: train on the {size_mb:.0f} MB store {json.dumps(res)}; {wall:.3f} s wall; "
        f"{len(made)} prefetch iterators (depth {made[0] if made else None}: the train epoch, "
        f"the val sweep, the final val and test sweeps); pool launches {pool}, expected {want} "
        f"(phase 5: (48, 20)); step p50 {res['train_step_ms_p50']:.3f} ms (phase 5 "
        f"{trained['train_step_ms_p50']:.3f} ms in this run); peak memory "
        f"{peak / 2**30:.2f} GiB")
    if len(made) != 4 or pool != (48, 20) or pool != want:
        raise RuntimeError(f"phase 12a: {len(made)} prefetch iterators, pool launches {pool}")
    if (steps, evals) != (trained["train_steps"], trained["eval_forwards"]):
        raise RuntimeError(f"phase 12a: {steps} steps, {evals} evals, not phase 5's")
    finals = [v for k, v in res.items() if k.startswith(("val_", "test_"))]
    if len(finals) != 8 or not all(math.isfinite(v) for v in finals):
        raise RuntimeError(f"phase 12a: non-finite or missing final metrics {res}")
    train_cases = {k: HURRICANES[k] for k in ("ian", "idalia")}
    prof = _host_path_profile(torch, store, train_cases)
    dev_busy = step_busy_share(torch, train_store)
    log(f"phase 12a: host path B=8 bf16: gather {prof['gather_ms']:.3f} ms and H2D "
        f"{prof['h2d_ms']:.3f} ms per {prof['batch_mb']:.1f} MB batch (timed apart); "
        f"{json.dumps(prof)}; device path, phase 5's store, the same step: "
        f"{json.dumps(dev_busy)}")
    out["a"] = {"step_ms_p50": res["train_step_ms_p50"],
                "phase5_step_ms_p50": trained["train_step_ms_p50"], "peak_gib": peak / 2**30,
                "pool_launches": pool, **prof,
                "device_path_busy_share": dev_busy["device_busy_share"]}

    # (b) float32: host path against the device path on the same store
    f32 = Config(data=DataConfig(data_dir=big, dataset_range=TRAIN_MARGIN,
                                 device_dtype="float32", pipeline="host"),
                 train=TrainConfig(batch_size=8, seed=0))
    ds, train_idx, _, _ = loop.prepare_datasets(f32, "michael")
    t0 = time.perf_counter()
    on_card = loop.make_pipeline(dataclasses.replace(f32, data=dataclasses.replace(
        f32.data, pipeline="device")), store, cuda)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    mcfg = ModelConfig(compute_dtype="float32", pool="pallas")
    sup = torch.from_numpy(model_supports(mcfg, 67, store.county_names)).cuda()
    var = weights.init_variables(mcfg, 7, 67, seed=3)

    def fresh():
        model = weights.load_variables(build_model(mcfg, 7, 67, 128), var).cuda()
        return model, create_train_state(model), make_train_step(model)

    torch.backends.cudnn.deterministic = True
    try:
        model, state, step = fresh()
        host_it = loop._epoch_iter(ds, train_idx, f32, True, 0, None, cuda)
        dev_it = loop._epoch_iter(ds, train_idx, f32, True, 0, on_card, cuda)
        equal, firsts = [], None
        for _ in range(3):
            hb, db = next(host_it), next(dev_it)
            step(state, hb, sup, LR, 0)  # kernels on the main stream between gets
            equal.append(all(torch.equal(hb[k], db[k]) for k in ("x", "y", "date_feats")))
            firsts = firsts or (hb, db)
        host_it.close()
        dev_it.close()
        del model, state, step
        grads = []
        for batch in firsts:
            model, state, step = fresh()
            loss = float(step(state, batch, sup, LR, 0)["loss"])
            grads.append((loss, {k: p.grad.clone() for k, p in model.named_parameters()
                                 if p.grad is not None}))
            del model, state, step
    finally:
        torch.backends.cudnn.deterministic = False
    (lh, gh), (ld, gd) = grads
    same_step = lh == ld and gh.keys() == gd.keys() and all(torch.equal(gh[k], gd[k]) for k in gh)
    bf16 = dataclasses.replace(f32.data, device_dtype="bfloat16")
    with closing(loop._epoch_iter(ds, train_idx, dataclasses.replace(f32, data=bf16), False, 0,
                                  None, cuda)) as it:
        host_x = next(it)["x"].dtype
    small_pipe = loop.make_pipeline(Config(data=dataclasses.replace(
        bf16, data_dir=train_store, pipeline="auto")), small, cuda)
    small_ds = loop.prepare_datasets(Config(data=dataclasses.replace(
        bf16, data_dir=train_store)), "michael")[0]
    dev_x = small_pipe.batch(small_ds, np.arange(8))["x"].dtype
    del small_pipe
    log(f"phase 12b: float32, the {size_mb:.0f} MB store: device path upload "
        f"{upload_s:.2f} s; first 3 train batches host == device (x, y, date_feats) {equal}; "
        f"one step from each path's first batch: loss {lh!r} vs {ld!r}, every gradient "
        f"bitwise equal {same_step}; bf16: host path x {host_x}, device path x {dev_x}")
    del on_card, firsts, grads, hb, db
    torch.cuda.empty_cache()
    if not all(equal) or not same_step:
        raise RuntimeError("phase 12b: the host path's batches or step differ from the "
                           "device path's")
    if (host_x, dev_x) != (torch.float32, torch.bfloat16):
        raise RuntimeError(f"phase 12b: x dtypes {host_x} (host), {dev_x} (device)")
    out["b"] = {"upload_s": upload_s, "batches_equal": equal, "step_equal": same_step}

    # (c) (a)'s checkpoint read back through the host path
    ckpt = os.path.join(workdir, "logs", "big", "checkpoints")
    common = ["--checkpoint_path", ckpt, "--case", "michael", "--batch_size", "8",
              "--dataset_range", str(TRAIN_MARGIN), "--data_dir", big]
    mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
    ev = cli.run(["evaluate", "--pool", "pallas", *common])
    torch.cuda.synchronize()
    pool, f = (mp.max_pool_forward.launches, mp.max_pool_backward.launches), ev["forwards"]
    gap = max(abs(ev["metrics"][k] - res[f"test_{k}"]) / abs(res[f"test_{k}"]) for k in METRICS)
    dcm.fused_double_conv.launches = gsm.gwnet_stack_forward.launches = 0
    dcm.fused_double_conv.up_launches = 0
    sv = cli.run(["serve", *common])
    torch.cuda.synchronize()
    grew, fs = (dcm.fused_double_conv.launches, gsm.gwnet_stack_forward.launches), sv["forwards"]
    gaps = {k: abs(sv["metrics"][k] - ev["metrics"][k]) / abs(ev["metrics"][k])
            for k in ("loss", "mae", "rmse")}
    log(f"phase 12c: evaluate --pool pallas {json.dumps(ev)}; pool launches {pool}; gap to "
        f"12a's test metrics {gap!r}; serve --checkpoint_path B=8 {json.dumps(sv)}; launches "
        f"(double_conv, gwnet_stack) {grew}; gaps to evaluate {json.dumps(gaps)}")
    if pool != (4 * f, 0) or gap != 0.0:
        raise RuntimeError(f"phase 12c: evaluate launched {pool} in {f} forwards, gap {gap}")
    if grew != (9 * fs, fs) or max(gaps.values()) > SERVE_RTOL:
        raise RuntimeError(f"phase 12c: serve launched {grew} in {fs} forwards, gaps {gaps}")
    check_up_launches(dcm, fs, "phase 12c")
    out["c"] = {"evaluate_gap": gap, "evaluate_pool_launches": pool, "serve_launches": grew,
                "serve_gaps": gaps}
    shutil.rmtree(big)
    shutil.rmtree(os.path.join(workdir, "logs", "big"))
    del store

    # (d) the hooks on phase 5's store, host path forced and device path
    mean32 = torch.tensor(DEFAULT_NTL_MEAN, device=cuda)
    std32 = torch.tensor(DEFAULT_NTL_STD, device=cuda)
    default = lambda w: pipeline.default_frame_transform(w, mean32, std32, 128)  # noqa: E731
    double = lambda w: 2.0 * default(w)  # noqa: E731
    cfgs = {p: Config(data=DataConfig(data_dir=train_store, dataset_range=TRAIN_MARGIN,
                                      device_dtype="float32", pipeline=p),
                      train=TrainConfig(batch_size=8, seed=0, epochs=1))
            for p in ("host", "device")}
    ds, train_idx, _, _ = loop.prepare_datasets(cfgs["host"], "michael")
    same = {}
    for name, tf in (("default", default), ("x2", double)):
        its = [loop._epoch_iter(ds, train_idx, cfg, True, 0,
                                loop.make_pipeline(cfg, small, cuda, tf), cuda,
                                frame_transform=tf) for cfg in cfgs.values()]
        pairs = list(zip(*its))
        same[name] = len(pairs) == -(-len(train_idx) // 8) and all(
            torch.equal(h[k], d[k]) for h, d in pairs for k in ("x", "y", "date_feats"))
        del pairs, its
    calls, want_calls = {}, {}

    def spy(name):
        def hook(batch):
            calls[name] = calls.get(name, 0) + 1
            return batch
        return hook

    for p, cfg in cfgs.items():  # bf16, the pool kernels, fit → predict → serve_eval
        cfg = dataclasses.replace(cfg, model=ModelConfig(pool="pallas"), data=dataclasses.replace(
            cfg.data, device_dtype="bfloat16"))
        run_dir = os.path.join(workdir, "logs", f"hooks_{p}")
        fitted = loop.fit(cfg, "michael", run_dir=run_dir, progress=False, device=cuda,
                          transform=spy(f"{p} fit"))
        ckpt = os.path.join(run_dir, "checkpoints")
        preds, _, _ = loop.predict(cfg, ckpt, "michael", device=cuda,
                                   transform=spy(f"{p} predict"))
        engine = ServingModel(cfg.model, restore_variables(ckpt), config_supports(cfg, small),
                              horizon=7, device=cuda)
        _, _, fwd = serve_eval(cfg.data, engine, small, "michael", 8,
                               transform=spy(f"{p} serve_eval"))
        # fit's eval_forwards counts its val, final val and test batches
        want_calls.update({f"{p} fit": fitted["train_steps"] + fitted["eval_forwards"],
                           f"{p} predict": -(-len(preds) // 8), f"{p} serve_eval": fwd})
        shutil.rmtree(run_dir)
    log(f"phase 12d: frame transform, host path == device path (float32, {len(train_idx)} "
        f"train windows): {json.dumps(same)}; counting transform calls "
        f"{json.dumps(calls)}, batches {json.dumps(want_calls)}")
    if not all(same.values()) or calls != want_calls:
        raise RuntimeError(f"phase 12d: transforms {same}, calls {calls} vs {want_calls}")
    out["d"] = {"frame_transform_equal": same, "transform_calls": calls}

    # (e) ingest at full width
    out["e"] = ingest_end_to_end(torch, cli, workdir, _Raster, NTL_VARIABLE, compute_mean_std)
    return out


def ingest_end_to_end(torch, cli, workdir, raster_cls, variable, compute_mean_std):
    """Phase 12e: a raw tree of 67 counties × the 17 dates of ±8 days
    around Michael, each county's rasters of one shape drawn from 90-260 ×
    140-310 (as each county keeps its bbox), 1% of pixels the fill
    sentinel, every tenth county pickled as the reference stores them, and
    an 18th date that one county lacks; `ingest --device cuda` against
    `ingest --device cpu` (the same dates and counties, frames within
    INGEST_ATOL / INGEST_RTOL), wall seconds and frames per second; then
    `ingest-monthly --device cuda` of three monthly composites and the
    store's normalization statistics."""
    import datetime
    import pickle

    import numpy as np

    from multimodal_outage_tpu_torch.core.config import NTL_FILL_SENTINEL
    from multimodal_outage_tpu_torch.core.registry import HURRICANES
    from multimodal_outage_tpu_torch.data.store import load_store

    raw = os.path.join(workdir, "raw")
    storm = HURRICANES["michael"]
    days = [storm + datetime.timedelta(days=i) for i in range(-INGEST_MARGIN, INGEST_MARGIN + 2)]
    counties = [f"county_{i:02d}" for i in range(67)]
    rng = np.random.default_rng(21)

    def raster(shape):
        arr = rng.gamma(2.0, 8.0, shape).astype(np.float32)
        arr.reshape(-1)[rng.choice(arr.size, arr.size // 100, replace=False)] = NTL_FILL_SENTINEL
        return arr

    t0 = time.perf_counter()
    raw_bytes = 0
    for ci, county in enumerate(counties):
        cdir = os.path.join(raw, county)
        os.makedirs(cdir)
        shape = (int(rng.integers(90, 261)), int(rng.integers(140, 311)))
        for d in days[:-1] if ci == 5 else days:
            arr = raster(shape)
            raw_bytes += arr.nbytes
            stem = os.path.join(cdir, f"{d.year}_{d.month}_{d.day}")
            if ci % 10 == 3:
                with open(stem + ".pickle", "wb") as f:
                    pickle.dump({variable: raster_cls(arr)}, f)
            else:
                np.save(stem + ".npy", arr)
        for m in (6, 7, 8):
            np.save(os.path.join(cdir, f"monthly_{storm.year}_{m}.npy"), raster(shape))
    log(f"phase 12e: raw tree of {len(counties)} counties × {len(days)} dates (one county "
        f"lacks the last), {raw_bytes / 1e6:.1f} MB of rasters, written in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    for dev in ("cuda", "cpu"):
        out_dir = os.path.join(workdir, f"ingested_{dev}")
        t0 = time.perf_counter()
        res = cli.run(["ingest", "--raw_dir", raw, "--out_dir", out_dir, "--device", dev])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[dev] = {"result": res, "wall_s": wall,
                     "frames_per_s": res["frames"][0] * res["frames"][1] / wall}
        log(f"phase 12e: ingest --device {dev} {json.dumps(res)}; {wall:.3f} s wall, "
            f"{runs[dev]['frames_per_s']:.1f} frames/s")
    a, b = (load_store(os.path.join(workdir, f"ingested_{d}")) for d in ("cuda", "cpu"))
    want_dates = [(d.year, d.month, d.day) for d in days[:-1]]
    err = float(np.abs(np.asarray(a.frames) - np.asarray(b.frames)).max())
    ok = (a.dates.tolist() == [list(d) for d in want_dates] and a.dates.tolist() == b.dates.tolist()
          and a.county_names == b.county_names == counties
          and np.allclose(a.frames, b.frames, atol=INGEST_ATOL, rtol=INGEST_RTOL)
          and float(np.asarray(a.frames).max()) < 1000)
    log(f"phase 12e: cuda vs cpu: {a.n_dates} dates, {a.n_counties} counties, frames "
        f"{a.frames.shape}, max |diff| {err!r} (atol {INGEST_ATOL}, rtol {INGEST_RTOL}), "
        f"largest value {float(np.asarray(a.frames).max())!r}; ok {ok}")
    if not ok:
        raise RuntimeError("phase 12e: ingest on the card differs from ingest on the CPU")
    store_dir = os.path.join(workdir, "ingested_cuda")
    t0 = time.perf_counter()
    mres = cli.run(["ingest-monthly", "--raw_dir", raw, "--store_dir", store_dir,
                    "--device", "cuda"])
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    store = load_store(store_dir)
    mean, std = compute_mean_std(store, {"michael": storm}, dataset_range=INGEST_MARGIN)
    log(f"phase 12e: ingest-monthly --device cuda {json.dumps(mres)}; {mwall:.3f} s; stats over "
        f"Michael ±{INGEST_MARGIN} {json.dumps({'mean': mean, 'std': std})}")
    if (store.monthly.shape != (3, 67, 128, 128) or not math.isfinite(mean) or not std > 0
            or float(store.monthly.max()) >= 1000):
        raise RuntimeError(f"phase 12e: monthly {store.monthly.shape}, stats {mean}, {std}")
    for d in ("raw", "ingested_cuda", "ingested_cpu"):
        shutil.rmtree(os.path.join(workdir, d))
    return {"cuda": {k: v for k, v in runs["cuda"].items() if k != "result"},
            "cpu": {k: v for k, v in runs["cpu"].items() if k != "result"},
            "max_abs_diff": err, "monthly_s": mwall, "stats": [mean, std]}


def _reference_checkpoint(torch, ti, weights, workdir, n_counties=67, image_size=128):
    """Phase 13a: a reference Lightning checkpoint of seeded full-width
    variables (BatchNorm statistics drawn in [0.5, 1.5], so a mean/var
    mix-up shows), in the reference's key layout: the port's
    export_state_dict under `model.`, with the num_batches_tracked counter
    of every BatchNorm and the 8 unused st_gnn.residual_convs (reference
    graph_wavenet.py:159,239-245) that every real one carries; and a
    whole-module Date2Vec .pth pickled through the port's shim. Returns
    (variables with the .pth's fc1/fc2, .ckpt path, .pth path)."""
    from multimodal_outage_tpu_torch.core.config import ModelConfig

    v = weights.init_variables(ModelConfig(), 7, n_counties, seed=13, image_size=image_size)
    g = torch.Generator().manual_seed(13)
    v["batch_stats"] = weights.unflatten({k: 0.5 + torch.rand(t.shape, generator=g)
                                          for k, t in weights.flatten(v["batch_stats"]).items()})
    sd = {f"model.{k}": torch.from_numpy(a) for k, a in ti.export_state_dict(v).items()}
    for k in [k for k in sd if k.endswith(".running_mean")]:
        sd[k.replace(".running_mean", ".num_batches_tracked")] = torch.tensor(240)
    for i in range(8):
        sd[f"model.st_gnn.residual_convs.{i}.weight"] = torch.randn(32, 32, 1, 1, generator=g)
        sd[f"model.st_gnn.residual_convs.{i}.bias"] = torch.randn(32, generator=g)
    ckpt = os.path.join(workdir, "reference.ckpt")
    torch.save({"state_dict": sd, "epoch": 3}, ckpt)
    ti._register_date2vec_shim()
    torch.manual_seed(13)
    d2v = sys.modules["date2vec"].Date2Vec(k=64)
    pth = os.path.join(workdir, "d2v.pth")
    torch.save(d2v, pth)
    v["params"]["date2vec"] = {
        fc: {"kernel": getattr(d2v, fc).weight.detach().t().contiguous(),
             "bias": getattr(d2v, fc).bias.detach().clone()} for fc in ("fc1", "fc2")}
    return v, ckpt, pth


def import_torch_end_to_end(torch, cli, dcm, gsm, mp, workdir, train_store, trained):
    """Phase 13: a reference Lightning checkpoint through `import-torch` on
    the card at full width (default ModelConfig: bf16, float32 params,
    Graph WaveNet; 67 counties, 128² frames; phase 5's store), the launch
    counters set to 0 just before each run and read just after. (a) the
    checkpoint and Date2Vec .pth (_reference_checkpoint); (b)
    `import-torch --checkpoint --d2v_pth --out logs/imported/checkpoints`,
    its wall time; (c) the restored leaves bitwise the source variables
    (Date2Vec fc1/fc2 the .pth's), a fresh Adam, step 0, the meta and the
    1e30 sentinel; (d) `evaluate --pool pallas` of the import against
    `evaluate` of a directory that CheckpointManager wrote directly from
    the same variables: equal metrics, 4 pool launches per batch; (e)
    `serve --checkpoint_path` of the import against `serve --weights` of
    an .npz of the same variables: equal predictions, 9 DoubleConv and 1
    stack launches per forward; (f) `train --resume --epochs 2` of job
    `imported`: it resumes from the import's epoch 0 at step 0, trains
    epoch 1 (pool launches as phase 5's), and best/ then holds epoch 1, not
    the sentinel; its step p50 beside phase 5's; (g) `import-torch --st_gnn
    dcrnn` raises the JAX package's ValueError and writes nothing.
    cuDNN runs deterministic in (d) and (e), so equal inputs give equal
    outputs."""
    import numpy as np

    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.checkpoint import CheckpointManager
    from multimodal_outage_tpu_torch.parity import torch_import as ti

    t_phase = time.perf_counter()
    v, ref, pth = _reference_checkpoint(torch, ti, weights, workdir)
    ckpt = os.path.join(workdir, "logs", "imported", "checkpoints")
    t0 = time.perf_counter()
    info = cli.run(["import-torch", "--checkpoint", ref, "--d2v_pth", pth, "--out", ckpt])
    wall = time.perf_counter() - t0
    log(f"phase 13b: import-torch {json.dumps(info)}; {wall:.3f} s wall")

    tree = CheckpointManager(ckpt).restore()
    want = {c: weights.flatten(v[c]) for c in ("params", "batch_stats")}
    off = [f"{c}/{k}" for c in want for k, t in weights.flatten(tree[c]).items()
           if k not in want[c] or not torch.equal(t, want[c][k])]
    off += [f"{c}/{k}" for c in want for k in want[c] if k not in weights.flatten(tree[c])]
    moments = weights.flatten(tree["opt_state"]["mu"]) | weights.flatten(tree["opt_state"]["nu"])
    meta = {"epoch": 0, "best_val": math.inf, "best_epoch": -1, "bad_epochs": 0}
    with open(os.path.join(ckpt, "best", "metrics.json")) as fh:
        index = json.load(fh)
    n_leaves = sum(len(w) for w in want.values())
    log(f"phase 13c: {n_leaves} leaves restored, {len(off)} differ from the source; Adam count "
        f"{tree['opt_state']['count']}, step {tree['step']}, meta {tree['meta']}, index {index}")
    if (off or info["leaves"] != n_leaves or tree["step"] != 0 or tree["meta"] != meta
            or tree["opt_state"]["count"] != 0 or any(t.any() for t in moments.values())
            or index != {"0": 1e30}):
        raise RuntimeError(f"phase 13c: the import is not the source: leaves off {off[:5]}")

    direct = os.path.join(workdir, "direct_checkpoints")
    CheckpointManager(direct).save(0, v, metrics={"val_loss": 0.0})
    npz = os.path.join(workdir, "imported.npz")
    weights.save_npz(npz, v)
    common = ["--case", "michael", "--batch_size", "8", "--dataset_range", str(TRAIN_MARGIN),
              "--data_dir", train_store]
    runs, launches = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, src in (("imported", ckpt), ("direct", direct)):
            mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
            runs[name] = cli.run(["evaluate", "--checkpoint_path", src, "--pool", "pallas",
                                  *common])
            torch.cuda.synchronize()
            launches[name] = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
        for name, src in (("serve_imported", ["--checkpoint_path", ckpt]),
                          ("serve_npz", ["--weights", npz])):
            dcm.fused_double_conv.launches = gsm.gwnet_stack_forward.launches = 0
            dcm.fused_double_conv.up_launches = 0
            preds = os.path.join(workdir, f"{name}_preds")
            runs[name] = cli.run(["serve", *src, *common, "--latency_stats", "--save_preds",
                                  preds])
            torch.cuda.synchronize()
            launches[name] = (dcm.fused_double_conv.launches, gsm.gwnet_stack_forward.launches)
            check_up_launches(dcm, runs[name]["forwards"], f"phase 13e {name}")
            runs[name]["preds"] = np.load(os.path.join(preds, "preds.npy"))
            shutil.rmtree(preds)
    finally:
        torch.backends.cudnn.deterministic = False
    ev, f = runs["imported"], runs["imported"]["forwards"]
    gap = max(abs(ev["metrics"][k] - runs["direct"]["metrics"][k]) for k in METRICS)
    log(f"phase 13d: evaluate --pool pallas of the import {json.dumps(ev)}; pool launches "
        f"(fwd, bwd) {launches['imported']}; largest metric gap to the direct checkpoint "
        f"{gap!r}")
    if launches["imported"] != (4 * f, 0) or gap != 0.0:
        raise RuntimeError(f"phase 13d: launches {launches}, metrics {ev['metrics']} vs "
                           f"{runs['direct']['metrics']}")
    sv, sn = runs["serve_imported"], runs["serve_npz"]
    f = sv["forwards"]
    d_preds = float(np.abs(sv["preds"] - sn["preds"]).max())
    log(f"phase 13e: serve --checkpoint_path of the import: {sv['forwards']} forwards, "
        f"metrics {json.dumps(sv['metrics'])}, launches (double_conv, gwnet_stack) "
        f"{launches['serve_imported']}; max |Δ| of the predictions to serve --weights "
        f"{d_preds!r}; p50 {sv['latency']['p50_ms']:.3f} ms p90 {sv['latency']['p90_ms']:.3f} "
        f"ms (B=8)")
    if (launches["serve_imported"] != (9 * f, f) or sv["preds"].shape != sn["preds"].shape
            or d_preds != 0.0 or not np.isfinite(sv["preds"]).all()):
        raise RuntimeError(f"phase 13e: launches {launches['serve_imported']}, max |Δ| "
                           f"{d_preds}")

    cwd = os.getcwd()
    os.chdir(workdir)  # the run directory is ./logs/<job_id>
    try:
        mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
        out = cli.run(["train", "--resume", "--job_id", "imported", "--epochs", "2", "--pool",
                       "pallas", *common])
        torch.cuda.synchronize()
        pool = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
    finally:
        os.chdir(cwd)
    with open(os.path.join(workdir, "logs", "imported", "metrics.jsonl")) as fh:
        epochs = [r["epoch"] for r in map(json.loads, fh) if r.get("phase") == "val"]
    with open(os.path.join(ckpt, "best", "metrics.json")) as fh:
        index = json.load(fh)
    latest = CheckpointManager(ckpt).restore_latest()
    steps, evals = out["train_steps"], out["eval_forwards"]
    log(f"phase 13f: train --resume from the import {json.dumps(out)}; val rows of epochs "
        f"{epochs}; pool launches (fwd, bwd) {pool}; best index {index}; latest step "
        f"{latest['step']}, Adam count {latest['opt_state']['count']}; step p50 "
        f"{out['train_step_ms_p50']:.3f} ms (phase 5: {trained['train_step_ms_p50']:.3f} ms)")
    if (epochs != [1] or steps != trained["train_steps"] or latest["step"] != steps
            or latest["opt_state"]["count"] != steps or pool != (4 * steps + 4 * evals, 4 * steps)
            or index != {"1": out["val_loss"]} or not out["val_loss"] < 1e30):
        raise RuntimeError(f"phase 13f: the resumed run is off: {out}")

    dcrnn_out = os.path.join(workdir, "dcrnn_import")
    try:
        cli.run(["import-torch", "--checkpoint", ref, "--out", dcrnn_out, "--st_gnn", "dcrnn"])
    except ValueError as e:
        if "no reference mapping for a DCRNN st-GNN" not in str(e) or os.path.exists(dcrnn_out):
            raise
        log(f"phase 13g: import-torch --st_gnn dcrnn raised ValueError: {e}")
    else:
        raise RuntimeError("phase 13g: import-torch --st_gnn dcrnn did not raise")
    return {"phase_s": time.perf_counter() - t_phase, "import_s": wall, "evaluate_gap": gap,
            "serve_max_abs_diff": d_preds,
            "serve_p50_ms": sv["latency"]["p50_ms"], "resumed_step_p50_ms":
            out["train_step_ms_p50"], "launches": {
                "evaluate_pool": launches["imported"], "serve": launches["serve_imported"],
                "train_pool": pool}}


def _bench_line_faults(out, detail_keys):
    """What is missing or off in one `bench` line: its keys, a finite
    value, and its detail keys, each numeric one finite."""
    faults = []
    if list(out) != ["metric", "value", "unit", "vs_baseline", "detail"]:
        faults.append(f"keys {list(out)}")
    v = out.get("value")
    if not isinstance(v, (int, float)) or not math.isfinite(v):
        faults.append(f"value {v!r}")
    detail = out.get("detail", {})
    if set(detail) != detail_keys:
        faults.append(f"detail keys {sorted(detail)}, expected {sorted(detail_keys)}")
    faults += [f"detail {k} {d!r}" for k, d in detail.items()
               if isinstance(d, float) and not math.isfinite(d)]
    return "; ".join(faults)


def conv_layout_held(torch, bm, failures):
    """Phase 14e: conv_layout's three layouts (benchmarks.conv_layout_fns)
    at its shapes and seeded bf16 inputs; for every ordered pair, each
    one's w1 and w2 gradients held to the other's against the float32
    nhwc gradients (compare's bf16 bar; TF32 is off here). Returns
    {"<a>_vs_<b>": {"w1": max |Δ|, "w2": ...}, "f32_max": {...},
    "<a>_vs_f32": {...}}."""
    x, w1, w2 = bm.conv_layout_inputs()
    grads = {k: fn() for k, fn in bm.conv_layout_fns(x, w1, w2).items()}
    truth = bm.conv_layout_fns(x.float(), w1.float(), w2.float())["nhwc"]()
    torch.cuda.synchronize()
    held = {"f32_max": {w: float(t.abs().max()) for w, t in zip(("w1", "w2"), truth)}}
    for a, g in grads.items():
        held[f"{a}_vs_f32"] = {w: float((g[i].float() - truth[i]).abs().max())
                               for i, w in enumerate(("w1", "w2"))}
    for a in grads:
        for b in grads:
            if a == b:
                continue
            row = {}
            for i, w in enumerate(("w1", "w2")):
                err, ok, note = compare(grads[a][i], grads[b][i], truth[i])
                row[w] = err
                if not ok:
                    failures.append(f"14e conv_layout {a} vs {b} d{w}: {err} ({note})")
            held[f"{a}_vs_{b}"] = row
    return held


def bench_end_to_end(torch, F, dcm, gsm, glm, dsm, mp, train_store, trained):
    """Phase 14: the `bench` configs (benchmarks.py) on the card at full
    width. (a) `bench --config e2e_train --steps 3` through the CLI in a
    subprocess (its own 0.5 GB store), its step seconds beside phase 5's
    p50; (b) batch_scaling's b=8 plain cell and b=32 plain, which must run
    out of memory, each in its own process; (c) how far the host runs ahead
    of the device in the e2e loop (host ms of a step's call and of the
    next batch's call, whose pageable index upload synchronises the
    stream, beside the pair's events ms); (d) every other
    ported config through run_benchmark at BENCH_STEPS, on phase 5's store,
    with torch's default TF32 settings (as a user runs `bench`), the
    launch counters set to 0 just before and read just after: each kernel
    must be launched, each line complete; (e) the A/B pairs that put a
    kernel against its module held to the port's bars, with TF32 off:
    kernel 2 and kernel 5 against the module at B=1 and 16 (float32, 1e-4;
    also their 20-forward CUDA-graph chains), kernel 3 in every layer
    against the module (float32), and the isolated pool at the B=8 stem
    shape (forward equal to F.max_pool2d, backward equal to the plain
    version of the kernel's tie rule; the positions where F.max_pool2d's
    backward routes a tie elsewhere are counted), and conv_layout's three
    layouts at its shapes in bf16, each one's w1 and w2 gradients held to
    each other's against a float32 run of nhwc (compare's bf16 bar). The
    launches of each config are logged too (layout_matrix and
    conv_layout launch no kernel of the port). Fails on a disagreement
    or a missing field, not on a time."""
    import gc
    import subprocess

    from multimodal_outage_tpu_torch import benchmarks as bm
    from multimodal_outage_tpu_torch.models.layers import max_pool_2x2

    t_phase = time.perf_counter()
    failures = []
    bm._E2E_STORE["dir"] = train_store  # phase 5's 67 × 128² store; no atexit cleanup
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 14: this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        "before the subprocess cells")

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "multimodal_outage_tpu_torch", "bench", "--config", "e2e_train",
         "--steps", "3"], cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600,
    )
    wall_e2e = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"phase 14a: bench e2e_train exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    e2e = json.loads(proc.stdout.strip().splitlines()[-1])
    p5 = trained["train_step_ms_p50"]
    ratio = 1e3 * e2e["detail"]["step_seconds"] / p5
    log(f"phase 14a: bench --config e2e_train --steps 3 (CLI, subprocess) {json.dumps(e2e)}; "
        f"{wall_e2e:.1f} s wall; step {1e3 * e2e['detail']['step_seconds']:.3f} ms over phase "
        f"5's p50 {p5:.3f} ms = {ratio:.4f}")
    bad = _bench_line_faults(e2e, {"step_seconds", "tiles_per_step", "batch", "remat",
                                   "oom_batches"})
    if bad or e2e["metric"] != "e2e_train_tiles_per_sec_per_chip" or e2e["detail"]["batch"] != 8:
        failures.append(f"14a e2e_train: {bad} {e2e}")

    t0 = time.perf_counter()
    bs = bm.run_benchmark("batch_scaling", steps=2, batches=(8, 32), rows=bm.SCALING_ROWS[:1])
    log(f"phase 14b: batch_scaling cells b8, b32 (a process each) {json.dumps(bs)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not isinstance(bs["detail"].get("b8"), float) or bs["detail"].get("b32") != "oom":
        failures.append(f"14b batch_scaling: b8 must run and b32 run out of memory: {bs}")

    su = bm.make_e2e_setup(8)
    run = bm._e2e_run(su, 8)
    run()
    torch.cuda.synchronize()
    batch, sync_rows = bm._e2e_batch(su, 8, 1), []
    for i in range(2, 6):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        su["step"](su["state"], batch, su["supports"], su["lr"], su["seed"])
        t1 = time.perf_counter()
        batch = bm._e2e_batch(su, 8, i)
        t2 = time.perf_counter()
        end.record()
        end.synchronize()
        sync_rows.append({"dispatch_ms": 1e3 * (t1 - t0), "next_batch_host_ms": 1e3 * (t2 - t1),
                          "events_ms": start.elapsed_time(end)})
    ahead = sorted(r["events_ms"] - r["dispatch_ms"] for r in sync_rows)[len(sync_rows) // 2]
    log(f"phase 14c: e2e loop, B=8: {json.dumps(sync_rows)}; the step's call returns "
        f"{ahead:.3f} ms (median) before its events close, so the next batch's synchronous "
        "index upload can wait at most that long")
    del su, run, batch
    gc.collect()
    torch.cuda.empty_cache()

    counters = {"double_conv": dcm.fused_double_conv, "gwnet_stack": gsm.gwnet_stack_forward,
                "max_pool_fwd": mp.max_pool_forward, "max_pool_bwd": mp.max_pool_backward,
                "gwnet_layer": glm.gwnet_layer_forward, "dcrnn_stack": dsm.dcrnn_stack_forward}
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    results, walls, per_config = {}, {}, {}
    try:
        for c in counters.values():
            c.launches = 0
        for name, steps in BENCH_STEPS.items():
            t0 = time.perf_counter()
            before = sum(c.launches for c in counters.values())
            out = bm.run_benchmark(name, steps=steps)
            walls[name] = time.perf_counter() - t0
            per_config[name] = sum(c.launches for c in counters.values()) - before
            log(f"phase 14d: bench --config {name} --steps {steps} {json.dumps(out)}; "
                f"{walls[name]:.1f} s")
            results[name] = out
            bad = _bench_line_faults(out, BENCH_DETAIL[name])
            if bad:
                failures.append(f"14d {name}: {bad}")
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"phase 14d: kernel launches of the configs {json.dumps(launches)}")
    log(f"phase 14d: kernel launches per config {json.dumps(per_config)}")
    if not all(launches.values()):
        failures.append(f"14d: a kernel was not launched: {launches}")

    dev = torch.device("cuda")
    holds = {}
    for b in (1, 16):
        for name, make in (("gwnet_stack", bm.gwnet_stack_fns), ("dcrnn_stack", bm.dcrnn_stack_fns)):
            fns, x, c_in, cores = make(b)
            err, ok, _ = compare(fns["stack"](), fns["module"]())
            chains = {k: bm._chained(core, x, c_in, dev)() for k, core in cores.items()}
            err_c, ok_c, _ = compare(chains["stack"], chains["module"])
            holds[f"{name}_b{b}"] = {"max_abs_err": err, "chain_max_abs_err": err_c}
            if not (ok and ok_c):
                failures.append(f"14e {name} B={b}: kernel vs module {err}, chains {err_c}")
            del fns, cores, chains
        fns = bm.gwnet_forecast_fns(b)
        err, ok, _ = compare(fns["pallas"](), fns["module"]())
        holds[f"gwnet_forecast_b{b}"] = {"max_abs_err": err}
        if not ok:
            failures.append(f"14e gwnet_forecast B={b}: kernel 3 vs module {err}")
    fns, x, g = bm.iso_pool_fns()
    xd = x.detach()
    fwd_err = float((mp.max_pool_forward(xd).float()
                     - max_pool_2x2(xd, "reduce_window").float()).abs().max())
    dx = fns["iso_pallas"]()
    bwd_err = float((dx.float() - mp.max_pool_backward_reference(xd, g).float()).abs().max())
    ties = int((dx != fns["iso_reduce_window"]()).sum())
    holds["iso_pool"] = {"fwd_vs_max_pool2d": fwd_err, "bwd_vs_plain": bwd_err,
                         "bwd_entries_routed_elsewhere_by_max_pool2d": ties}
    if fwd_err or bwd_err:
        failures.append(f"14e iso pool: forward {fwd_err}, backward {bwd_err}")
    del fns, x, g, xd, dx
    holds["conv_layout"] = conv_layout_held(torch, bm, failures)
    log(f"phase 14e: A/B pairs held {json.dumps(holds)}")
    if failures:
        raise RuntimeError("phase 14: " + "\n".join(failures))
    return {"phase_s": time.perf_counter() - t_phase, "e2e": e2e, "e2e_over_phase5": ratio,
            "batch_scaling": bs["detail"], "host_ahead_ms": ahead,
            "sync_rows": sync_rows, "configs": {k: v["value"] for k, v in results.items()},
            "walls": walls, "holds": holds, "launches": launches}


def _p15_steps(mesh, store_dir, variables, cases, seed):
    """Phase 15a/15b rank entry: the float32 train step of each case (key,
    mesh shape, ModelConfig fields, rows of phase 5's first batch, padded
    batch size) on this world's ranks; rank 0 returns {key: (loss, BN
    stats, full params, each rank's kernel 3 launches, the full summed
    gradients before Adam's step)}."""
    import torch
    import torch.distributed as dist

    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import ModelConfig
    from multimodal_outage_tpu_torch.core.mesh import Mesh, MeshShape
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.ops import gwnet_layer as glm
    from multimodal_outage_tpu_torch.parallel import sharding
    from multimodal_outage_tpu_torch.train.state import create_train_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _, full = train_batch(torch, store_dir)
    sup = torch.eye(67, device=mesh.device)[None]
    out = {}
    for key, shape, model_kw, rows, bsize in cases:
        shape = MeshShape(*shape)
        m = mesh if shape == mesh.shape else Mesh(shape, mesh.device)
        cfg = ModelConfig(compute_dtype="float32", **model_kw)
        model = weights.load_variables(build_model(cfg, 7, 67, 128), variables)
        sharding.shard_model(model, m)
        model.to(m.device)
        batch = {k: v[:rows].float() if k != "date_feats" else v[:rows]
                 for k, v in full.items()}
        part = sharding.shard_batch(m, sharding.pad_batch(
            {k: v.cpu().numpy() for k, v in batch.items()}, bsize))
        before = glm.gwnet_layer_forward.launches
        metrics = sharding.make_sharded_train_step(model, m)(
            create_train_state(model), part, sup, LR, seed)
        torch.cuda.synchronize()
        launched = torch.zeros(m.shape.size, device=m.device)
        launched[m.rank] = glm.gwnet_layer_forward.launches - before
        dist.all_reduce(launched)
        v = weights.module_variables(model)
        params = sharding.gather_tree(v["params"], m)
        grads = sharding.gather_tree(weights.unflatten(_grads(torch, model)), m)
        out[key] = (float(metrics["loss"]),
                    {k: t.float().cpu().numpy() for k, t in weights.flatten(v["batch_stats"]).items()},
                    {k: t.float().cpu().numpy() for k, t in weights.flatten(params).items()},
                    launched.cpu().tolist(),
                    {k: t.float().cpu().numpy() for k, t in weights.flatten(grads).items()})
        del model, part
        torch.cuda.empty_cache()
    return out if mesh.is_main else None


def _grads(torch, model):
    """{leaf path: its gradient} (zeros where a leaf took none); the
    train steps clear .grad at their start, so after a step it holds that
    step's gradient, summed over the ranks on a mesh."""
    return {k.replace(".", "/"): (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
            for k, p in model.named_parameters()}


def _one_rank_step(torch, store_dir, variables, model_kw, rows, seed):
    """The plain one-device float32 step of phase 15a's bars, on the first
    `rows` windows of phase 5's first batch: (loss, BN stats, params,
    None, gradients), as _p15_steps."""
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import ModelConfig
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import make_train_step

    _, full = train_batch(torch, store_dir)
    batch = {k: v[:rows].float() if k != "date_feats" else v[:rows] for k, v in full.items()}
    model = weights.load_variables(
        build_model(ModelConfig(compute_dtype="float32", **model_kw), 7, 67, 128), variables)
    model.cuda()
    m = make_train_step(model)(create_train_state(model), batch,
                               torch.eye(67, device="cuda")[None], LR, seed)
    v = weights.module_variables(model)
    out = (float(m["loss"]),
           {k: t.float().cpu().numpy() for k, t in weights.flatten(v["batch_stats"]).items()},
           {k: t.float().cpu().numpy() for k, t in weights.flatten(v["params"]).items()},
           None, {k: t.float().cpu().numpy() for k, t in _grads(torch, model).items()})
    del model
    torch.cuda.empty_cache()
    return out


def _mesh_gaps(got, want):
    """(loss rel, worst BN buffer rel to its largest entry, worst param
    |Δ|, share of param entries within JAX's rtol 1e-2 / atol 5e-4, worst
    gradient leaf rel to max(its largest entry, 1e-3 of the largest
    gradient of all))."""
    import numpy as np

    loss = abs(got[0] - want[0]) / abs(want[0])
    stat = max(float(np.abs(got[1][k] - w).max()) / max(float(np.abs(w).max()), 1e-12)
               for k, w in want[1].items())
    worst, inside, total = 0.0, 0, 0
    for k, w in want[2].items():
        d = np.abs(got[2][k] - w)
        worst = max(worst, float(d.max()))
        inside += int(np.sum(d <= 5e-4 + 1e-2 * np.abs(w)))
        total += d.size
    g_all = max(float(np.abs(w).max()) for w in want[4].values())
    grad = max(float(np.abs(got[4][k] - w).max())
               / max(float(np.abs(w).max()), 1e-3 * g_all, 1e-30)
               for k, w in want[4].items())
    return loss, stat, worst, inside / total, grad


def _mesh_ok(g, vs_native=None):
    """Phase 15a's bars (MESH_* above) on _mesh_gaps `g`. vs_native: the
    worst gradient leaf of the mesh step and of the one-rank step, each
    against the one-rank step with cuDNN off; the gradient bar is then
    MESH_GRAD_RATIO times the one-rank step's plus MESH_GRAD_RTOL. The
    worst parameter |Δ| is reported only: Adam's first step moves an entry
    by at most lr, whatever its gradient, so no bar on it could fail."""
    grad_ok = (g[4] <= MESH_GRAD_RTOL if vs_native is None
               else vs_native[0] <= MESH_GRAD_RATIO * vs_native[1] + MESH_GRAD_RTOL)
    return (g[0] <= MESH_LOSS_RTOL and g[1] <= MESH_STAT_RTOL and grad_ok
            and g[3] >= MESH_PARAM_SHARE)


def _with_virtual(n, fn, *a, **kw):
    """fn(*a, **kw) with MULTIMODAL_OUTAGE_TORCH_VIRTUAL_DEVICES=n."""
    from multimodal_outage_tpu_torch.core.mesh import VIRTUAL_DEVICES_ENV

    old = os.environ.get(VIRTUAL_DEVICES_ENV)
    os.environ[VIRTUAL_DEVICES_ENV] = str(n)
    try:
        return fn(*a, **kw)
    finally:
        if old is None:
            os.environ.pop(VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = old


def mesh_steps_end_to_end(torch, train_store):
    """Phases 15a and 15b's float32 steps (MESH_* bars), ranks sharing
    cuda:0 over gloo: B=8 on 2x1x1, 1x2x1 and 1x1x7 and the padded ragged
    tail against the one-rank step, their gradients also against the
    one-rank step without cuDNN; remat_scope all on 1x1x7 against the
    same mesh without remat; 2x1x1 with the per-layer Graph WaveNet kernel
    (kernel 3) against the plain layer on the same mesh, with its launches
    per rank. Raises when a step misses its bars."""
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import ModelConfig
    from multimodal_outage_tpu_torch.core.mesh import MeshShape
    from multimodal_outage_tpu_torch.parallel import launch

    out = {}
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False  # as in the ranks (_p15_steps)
    torch.backends.cuda.matmul.allow_tf32 = False
    variables = weights.init_variables(ModelConfig(), 7, 67, seed=3)
    no_drop = {"encoder_dropout": 0.0}
    plain3 = {**no_drop, "gwnet": _gwnet_cfg(dropout=0.0)}
    pallas = {"gwnet": _gwnet_cfg(use_pallas=True)}
    cases2 = [("2x1x1", (2, 1, 1), {}, 8, 8), ("1x2x1", (1, 2, 1), {}, 8, 8),
              ("ragged", (2, 1, 1), plain3, 3, 8), ("pallas", (2, 1, 1), pallas, 8, 8)]
    cases7 = [("1x1x7", (1, 1, 7), {}, 8, 8),
              ("remat", (1, 1, 7), {"remat": True, "remat_scope": "all"}, 8, 8)]
    t0 = time.perf_counter()
    got = launch.run(_p15_steps, MeshShape(2, 1, 1), "cuda", (train_store, variables, cases2, 0))
    t2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    got.update(launch.run(_p15_steps, MeshShape(1, 1, 7), "cuda",
                          (train_store, variables, cases7, 0)))
    t7 = time.perf_counter() - t0
    refs, native = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for rows, kw in ((8, {}), (3, plain3)):
            refs[rows] = _one_rank_step(torch, train_store, variables, kw, rows, 0)
        torch.backends.cudnn.enabled = False
        for rows, kw in ((8, {}), (3, plain3)):
            native[rows] = _one_rank_step(torch, train_store, variables, kw, rows, 0)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.enabled = True
    e_one = {rows: _mesh_gaps(refs[rows], native[rows])[4] for rows in refs}
    failures = []
    for key, rows, what in (("2x1x1", 8, "one rank"), ("1x2x1", 8, "one rank"),
                            ("1x1x7", 8, "one rank"), ("ragged", 3, "one rank, B=3"),
                            ("remat", None, "1x1x7 without remat"),
                            ("pallas", None, "the plain layer on 2x1x1")):
        want = refs[rows] if rows else got["1x1x7" if key == "remat" else "2x1x1"]
        g = _mesh_gaps(got[key], want)
        vs = (_mesh_gaps(got[key], native[rows])[4], e_one[rows]) if rows else None
        ok = _mesh_ok(g, vs)
        log(f"phase 15{'b' if key == 'pallas' else 'a'}: {key} float32 step vs {what}: loss rel "
            f"{g[0]:.3g}, worst BN buffer rel {g[1]:.3g}, worst gradient leaf rel {g[4]:.3g}"
            + (f" (against the one-rank step without cuDNN {vs[0]:.3g}, the one-rank step's "
               f"own {vs[1]:.3g})" if vs else "")
            + f", worst param |Δ| {g[2]:.3g}, {100 * g[3]:.3f}% of entries within rtol "
            f"1e-2/atol 5e-4; ok {ok}")
        out[key] = {"gaps": list(g), "grad_vs_native": list(vs) if vs else None, "ok": ok}
        if not ok:
            failures.append(key)
    log(f"phase 15a: worlds: 2 ranks {t2:.1f} s, 7 ranks {t7:.1f} s wall")
    launches = got["pallas"][3]
    log(f"phase 15b: kernel 3 launches per rank under 2x1x1 {launches} (8 per step)")
    if launches != [8.0, 8.0] or got["2x1x1"][3] != [0.0, 0.0]:
        failures.append(f"kernel 3 launches {launches}, plain {got['2x1x1'][3]}")
    out["kernel3_launches_per_rank"] = launches
    if failures:
        raise RuntimeError(f"phase 15a/b: mesh steps off their bars: {failures}")
    return out


def mesh_end_to_end(torch, cli, workdir, train_store, trained, p7):
    """Phase 15: the mesh on the one card at full width. Ranks share
    cuda:0 over gloo (the virtual-device variable); time on a shared card
    is not multi-card scaling (the ranks take turns on it, gloo stages
    every CUDA collective through the host). (a, b) the float32 steps of
    mesh_steps_end_to_end; bf16 `train` of phase 5's store on 1x2x1,
    resumed on 2x1x1 (d: a checkpoint written on one mesh resumes on
    another), and on 1x1x7: step p50, peak memory and collective seconds
    per rank. (c) evaluate and serve of phase 5's checkpoint on 2x1x1
    against one device (phase 7's numbers), 18 windows after the trim. (e)
    bench sharded_pipeline and serving_sharded on an NCCL group of one
    rank. (f) two host processes (--coordinator_address) against one
    process of two ranks."""
    import subprocess

    from multimodal_outage_tpu_torch.parallel import launch

    out = mesh_steps_end_to_end(torch, train_store)

    cwd = os.getcwd()
    os.chdir(workdir)
    common = ["--data_dir", train_store, "--case", "michael", "--dataset_range", str(TRAIN_MARGIN),
              "--batch_size", "8"]
    try:
        fits = {}
        for key, n, flags in (("1x2x1", 2, ["--mesh_data", "1", "--mesh_model", "2",
                                             "--epochs", "1", "--job_id", "mesh"]),
                              ("2x1x1", 2, ["--mesh_data", "2", "--epochs", "2", "--resume",
                                            "--job_id", "mesh"]),
                              ("1x1x7", 7, ["--mesh_data", "1", "--mesh_time", "7",
                                            "--epochs", "1", "--job_id", "mesh7"])):
            t0 = time.perf_counter()
            res = _with_virtual(n, cli.run, ["train", *common, "--seed", "0", *flags])
            wall = time.perf_counter() - t0
            finals = [res[f"{p}_{m}"] for p in ("val", "test") for m in METRICS]
            ranks = res["ranks"]
            log(f"phase 15a: train bf16 on {key}: step p50 {res.get('train_step_ms_p50', 0):.3f} "
                f"ms (rank 0; phase 5 one device {trained['train_step_ms_p50']:.3f} ms); peak "
                f"memory per rank {[round(r['peak_mem_mb']) for r in ranks]} MiB; host s in "
                f"collectives per rank {[round(r['collective_s'], 3) for r in ranks]}; "
                f"train_steps {res['train_steps']}; {wall:.1f} s wall; test_loss "
                f"{res['test_loss']!r}")
            if res["mesh"] != key or not all(math.isfinite(v) for v in finals):
                raise RuntimeError(f"phase 15a: train on {key}: {res}")
            fits[key] = {k: res[k] for k in ("train_step_ms_p50", "train_steps", "test_loss")
                         if k in res}
            fits[key]["ranks"] = ranks
        rows = [json.loads(x) for x in open(os.path.join("logs", "mesh", "metrics.jsonl"))]
        epochs = [r["epoch"] for r in rows if r["phase"] == "val"]
        log(f"phase 15d: a checkpoint written on 1x2x1 resumed on 2x1x1: val epochs {epochs}, "
            f"global step {fits['2x1x1']['train_steps']}")
        if epochs != [0, 1] or fits["2x1x1"]["train_steps"] != 2 * fits["1x2x1"]["train_steps"]:
            raise RuntimeError(f"phase 15d: resume across meshes: epochs {epochs}, {fits}")
        out["fits"] = fits

        ckpt = os.path.join(workdir, "logs", "smoke", "checkpoints")
        ev = _with_virtual(2, cli.run, ["evaluate", "--checkpoint_path", ckpt, *common,
                                        "--mesh_data", "2"])
        sv = _with_virtual(2, cli.run, ["serve", "--checkpoint_path", ckpt, *common,
                                        "--mesh_data", "2", "--latency_stats"])
        gaps = {"evaluate": max(abs(ev["metrics"][k] - p7["evaluate_metrics"][k])
                                / abs(p7["evaluate_metrics"][k]) for k in ("loss", "mae", "rmse")),
                "serve": max(abs(sv["metrics"][k] - p7["serve_metrics"][k])
                             / abs(p7["serve_metrics"][k]) for k in ("loss", "mae", "rmse"))}
        log(f"phase 15c: evaluate on 2x1x1 {json.dumps(ev)}; serve on 2x1x1 {json.dumps(sv)}; "
            f"largest relative gaps to one device (phase 7) {json.dumps(gaps)}")
        if ev["windows"] != 18 or gaps["evaluate"] > MESH_EVAL_RTOL or gaps["serve"] > SERVE_RTOL:
            raise RuntimeError(f"phase 15c: {ev['windows']} windows, gaps {gaps}")
        out["eval_serve_gaps"] = gaps

        benches = {}
        for name in ("sharded_pipeline", "serving_sharded"):
            t0 = time.perf_counter()
            b = cli.run(["bench", "--config", name, "--steps", "3"])
            benches[name] = b
            log(f"phase 15e: bench --config {name} (an NCCL group of one rank): "
                f"{json.dumps(b)}; {time.perf_counter() - t0:.1f} s wall")
            if not (b["value"] > 0 and b["detail"]["devices"] == torch.cuda.device_count()):
                raise RuntimeError(f"phase 15e: {name}: {b}")
        out["bench"] = {k: v["value"] for k, v in benches.items()}

        small = ["train", "--data_dir", train_store, "--case", "michael", "--dataset_range", "8",
                 "--batch_size", "2", "--seed", "0", "--epochs", "1", "--mesh_data", "2"]
        one = _with_virtual(2, cli.run, [*small, "--job_id", "hosts_one"])
        port = launch._free_port()
        env = {**os.environ, "MULTIMODAL_OUTAGE_TORCH_VIRTUAL_DEVICES": "1",
               "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", "multimodal_outage_tpu_torch", *small,
                                   "--job_id", "hosts_two", "--coordinator_address",
                                   f"127.0.0.1:{port}", "--num_processes", "2",
                                   "--process_id", str(i)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=env)
                 for i in range(2)]
        two = []
        try:
            for p in procs:
                so, se = p.communicate(timeout=300)
                if p.returncode != 0:
                    raise RuntimeError(f"phase 15f: a host process exited {p.returncode}: "
                                       f"{se[-2000:]}")
                two.append(json.loads(so.strip().splitlines()[-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        keys = [f"{p}_{m}" for p in ("val", "test") for m in METRICS] + ["train_steps"]
        same = all(t[k] == one[k] for t in two for k in keys)
        log(f"phase 15f: two host processes (--coordinator_address, one rank each on the "
            f"shared card) {time.perf_counter() - t0:.1f} s wall: test_loss "
            f"{[t['test_loss'] for t in two]} vs one process of two ranks {one['test_loss']!r}; "
            f"equal {same}")
        if not same:
            raise RuntimeError(f"phase 15f: {two} vs {one}")
        out["hosts_equal"] = same
    finally:
        os.chdir(cwd)
    return out


def _gwnet_cfg(**kw):
    """GWNetConfig(**kw), phase 15's model variants."""
    from multimodal_outage_tpu_torch.core.config import GWNetConfig

    return GWNetConfig(**kw)


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
        p11 = accum_remat_end_to_end(torch, cli, mp, workdir, train_store)
        log(f"phase 11: {json.dumps(p11)}")
        p12 = data_path_end_to_end(torch, cli, dcm, gsm, mp, workdir, train_store, trained)
        log(f"phase 12: {json.dumps(p12)}")
        p13 = import_torch_end_to_end(torch, cli, dcm, gsm, mp, workdir, train_store, trained)
        log(f"phase 13: {json.dumps(p13)}")
        p14 = bench_end_to_end(torch, F, dcm, gsm, glm, dsm, mp, train_store, trained)
        log(f"phase 14: {json.dumps(p14)}")
        t15 = time.perf_counter()
        p15 = mesh_end_to_end(torch, cli, workdir, train_store, trained, p7)
        log(f"phase 15: {json.dumps(p15)}; {time.perf_counter() - t15:.1f} s")

    # one B=1 bf16 forward's kernel 1 calls: the 5 contraction shapes in the
    # plain form, the 4 up levels in the up form
    main_dc = ([r for r in dc_rows if r["form"] == "plain" and r["dtype"] == "bfloat16"][:5]
               + [r for r in dc_rows if r["form"] == "up" and r["M"] == M_B1])
    assert [(r["H"], r["C"]) for r in main_dc] == [(h, c) for h, _, c in DOUBLE_CONV_SHAPES]
    main_st = [r for r in st_rows if r["dtype"] == "bfloat16" and r["B"] == 1][0]
    dc_bytes = sum(r["bytes"] for r in main_dc) / H100_BYTES_PER_S
    dc_ops = sum(r["flop"] for r in main_dc) / PEAK_OPS["bfloat16"]
    kernels = [
        {
            "name": "double_conv", "route": "cuda",
            "source": "multimodal_outage_tpu_torch/csrc/double_conv.cu",
            "replaces": "multimodal_outage_tpu/ops/unet_pallas.py:119",
            "launches": launches["double_conv"],
            "up_launches": launches["double_conv_up"],  # of them, the up form's
            "launches_phase12": p12["c"]["serve_launches"][0],  # 12c: serve from the host path
            "launches_phase13": p13["launches"]["serve"][0],  # 13e: serve of an import
            "launches_phase14": p14["launches"]["double_conv"],  # 14d: the bench configs
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
            "launches_phase12": p12["c"]["serve_launches"][1],
            "launches_phase13": p13["launches"]["serve"][1],
            "launches_phase14": p14["launches"]["gwnet_stack"],
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
            # phase 11's runs: (a) grad_accum 2, (e) remat stem, (c) auto at B=32
            "launches_phase11": {k: p11[k]["pool_launches"][i] for k in ("a", "e", "c")},
            # phase 12: (a) train and (c) evaluate through the host path
            "launches_phase12": {"a": p12["a"]["pool_launches"][i],
                                 "c": p12["c"]["evaluate_pool_launches"][i]},
            # phase 13: (d) evaluate and (f) train --resume of an import
            "launches_phase13": {"d": p13["launches"]["evaluate_pool"][i],
                                 "f": p13["launches"]["train_pool"][i]},
            "launches_phase14": p14["launches"][name],
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
         {"device_ms": main_gl["device_ms"], **by_supports(gl9_rows, 8),
          # 15b: one 2x1x1 step, launches on each rank (its own process)
          "launches_phase15_per_rank": p15["kernel3_launches_per_rank"]}),
        ("dcrnn_stack", "dcrnn_stack.cu", "dcrnn_stack_pallas.py:169", dcrnn_launches, main_ds,
         {}),
    ):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"multimodal_outage_tpu_torch/csrc/{src}",
            "replaces": f"multimodal_outage_tpu/ops/{replaces}",
            "launches": n, "launches_phase14": p14["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None, **extra,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s; kernel times are bf16: one B=1 "
        "serving forward's calls (double_conv: the sum of its 5 contraction shapes and its "
        "up form at the 4 up levels, plain_ms and library_ms the same levels as "
        "ConvTranspose → concat → DoubleConv), one B=8 "
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
