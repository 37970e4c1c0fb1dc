#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on the
card, at full width: 67 counties × 7 days × 128² frames, bf16 compute,
pool="pallas" (the max-pool kernel pair), random weights and batch from
a seed.

    python3 tools/profile_train_torch.py [--batch 8 16] [--steps 5] [--out FILE]
        [--st_gnn dcrnn [--teacher_forcing P] [--tf_decay_steps TAU]]

For each batch size: whether the step fits in device memory and its
peak (torch.cuda.max_memory_allocated); the step's wall time (CUDA
events, p50 over --steps steps after two warm-up steps); the train-mode
forward alone, whole and per top-level module (contraction, encoder,
date2vec, st_gnn, decoder, expansion), and the Adam update alone (CUDA
events, p50), so that backward ≈ step − forward − Adam; and
torch.profiler's device time per kernel over --steps steps, divided by
their count and grouped by kind of work, with the device's busy share of
the wall time. A batch size that runs out of memory is reported as not
fitting, with the peak reached before the failure. With --st_gnn dcrnn
the st-GNN is the default DCRNN over the Florida graph's dual-random-walk
supports, and with --teacher_forcing each step also encodes the batch's
future frames (the eval-mode teacher pass). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

# kernel-name fragments → the kind of work in a train step, first match wins
KINDS = (
    ("max_pool_fwd_kernel", "max-pool kernel, forward"),
    ("max_pool_bwd_kernel", "max-pool kernel, backward"),
    ("nhwcaddpadding", "convolution (cuDNN)"),
    ("dgrad", "convolution backward (cuDNN dgrad/wgrad)"),
    ("wgrad", "convolution backward (cuDNN dgrad/wgrad)"),
    ("conv", "convolution (cuDNN)"),
    ("xmma_fprop", "convolution (cuDNN)"),
    ("fprop", "convolution (cuDNN)"),
    ("gemm", "matrix products (cuBLAS)"),
    ("gemv", "matrix products (cuBLAS)"),
    ("cutlass", "matrix products (cuBLAS)"),
    ("reduce", "reductions (BatchNorm statistics, bias grads)"),
    ("cat", "concat / copy / cast"),
    ("copy", "concat / copy / cast"),
    ("elementwise", "elementwise (BatchNorm, ReLU, casts, Adam)"),
    ("foreach", "elementwise (BatchNorm, ReLU, casts, Adam)"),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for frag, kind in KINDS:
        if frag in low:
            return kind
    return "other"


def p50(times):
    times = sorted(times)
    return times[len(times) // 2]


def forward_split(torch, model, batch, sup, reps: int, **kw):
    """p50 CUDA-event ms of the train-mode forward (graph built, no
    backward), whole and per top-level module; a module called twice in a
    forward (the contraction and encoder with the teacher pass, given
    kw = targets, tf_prob) counts both calls."""
    marks, hooks = {}, []
    for name, mod in model.named_children():
        def pre(m, inp, name=name):
            marks.setdefault(name, []).append([len(whole), torch.cuda.Event(enable_timing=True),
                                               None])
            marks[name][-1][1].record()

        def post(m, inp, out, name=name):
            marks[name][-1][2] = torch.cuda.Event(enable_timing=True)
            marks[name][-1][2].record()

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    whole = []
    try:
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = model(batch["x"], batch["date_feats"], sup, train=True, **kw)
            end.record()
            end.synchronize()
            whole.append(start.elapsed_time(end))
            del y
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    per_rep = lambda v: [sum(a.elapsed_time(b) for r_, a, b in v if r_ == r) for r in range(reps)]
    return p50(whole), {k: p50(per_rep(v)) for k, v in marks.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_train_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from multimodal_outage_tpu_torch.core.config import DCRNNConfig, ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import (
        make_train_step,
        tf_schedule,
        uses_teacher_forcing,
    )
    from multimodal_outage_tpu_torch.weights import init_variables, load_variables

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", type=str, default=None, help="also write the report as JSON here")
    ap.add_argument("--st_gnn", choices=("gwnet", "dcrnn"), default="gwnet")
    ap.add_argument("--teacher_forcing", type=float, default=0.0)
    ap.add_argument("--tf_decay_steps", type=int, default=0)
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {"device": torch.cuda.get_device_name(0), "card": card, "st_gnn": args.st_gnn,
              "teacher_forcing": args.teacher_forcing, "tf_decay_steps": args.tf_decay_steps}
    cfg = ModelConfig(pool="pallas", st_gnn=args.st_gnn,
                      dcrnn=DCRNNConfig(teacher_forcing=args.teacher_forcing,
                                        tf_decay_steps=args.tf_decay_steps))
    sup = torch.from_numpy(model_supports(cfg, 67)).cuda()
    for b in args.batch:
        model = load_variables(build_model(cfg, 7, 67, 128), init_variables(cfg, 7, 67, seed=0))
        model.cuda()
        state, step = create_train_state(model), make_train_step(model)
        gen = torch.Generator(device="cuda").manual_seed(b)
        batch = {
            "x": torch.randn(b, 67, 7, 128, 128, 1, generator=gen, device="cuda").to(torch.bfloat16),
            "y": torch.randn(b, 67, 7, 128, 128, 1, generator=gen, device="cuda"),
            "date_feats": torch.tensor([0, 0, 0, 2018, 10, 1], dtype=torch.float32,
                                       device="cuda").repeat(b, 7, 1),
        }
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row = {"batch": b}
        try:
            for _ in range(2):
                step(state, batch, sup, 1e-3, 0)
            torch.cuda.synchronize()
            walls = []
            for _ in range(args.steps):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                step(state, batch, sup, 1e-3, 0)
                end.record()
                end.synchronize()
                walls.append(start.elapsed_time(end))
            tf = {}
            if uses_teacher_forcing(model):
                tf = {"targets": batch["y"], "tf_prob": float(tf_schedule(model, state.step))}
            fwd_ms, fwd_modules = forward_split(torch, model, batch, sup, args.steps, **tf)
            adam = []
            for _ in range(args.steps):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state.opt.step(1e-3)
                end.record()
                end.synchronize()
                adam.append(start.elapsed_time(end))
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(args.steps):
                    step(state, batch, sup, 1e-3, 0)
                torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            row.update(fits=False, peak_bytes=torch.cuda.max_memory_allocated(),
                       error=str(e).splitlines()[0])
        else:
            per_kernel = defaultdict(float)
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    per_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3 / args.steps
            per_kind = defaultdict(float)
            for name, ms in per_kernel.items():
                per_kind[kind_of(name)] += ms
            busy = sum(per_kernel.values())
            wall = p50(walls)
            row.update(
                fits=True, peak_bytes=torch.cuda.max_memory_allocated(),
                step_ms_p50=wall, step_ms_all=walls, forward_ms_p50=fwd_ms,
                forward_modules_ms_p50=fwd_modules, adam_ms_p50=p50(adam),
                backward_ms_est=wall - fwd_ms - p50(adam), device_busy_ms=busy,
                device_busy_share=busy / wall if busy else None,
                kinds_ms=dict(sorted(per_kind.items(), key=lambda kv: -kv[1])),
                top_kernels_ms=dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]),
            )
        report[f"B={b}"] = row
        print(json.dumps(row), flush=True)
        del model, state, step, batch
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
