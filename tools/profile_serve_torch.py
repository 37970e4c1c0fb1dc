#!/usr/bin/env python3
"""Where the time of one serving forward of the PyTorch port goes, on the
card: full width (67 counties × 7 days × 128² frames, bf16, random
weights from a seed), at each requested batch size, with Graph WaveNet,
DCRNN or GMAN as the st-GNN.

    python3 tools/profile_serve_torch.py [--st_gnn gwnet|dcrnn|gman] [--batch 1 16]
        [--repeats 5] [--out FILE] [--gwnet_kernel_size K] [--no_gcn]

--gwnet_kernel_size > 1 or --no_gcn profile a non-fused Graph WaveNet,
which the engine serves through its eval-mode module (models/gwnet.py),
not the stack kernel.

Prints per batch size the forward's wall time (CUDA events, after a
warm-up), then, over the profiled forwards, the engine's stage table from
the program's own spans (core/tracing.py: engine.contraction,
engine.st_gnn, engine.expansion and the root engine.forward's own part,
the bottleneck Dense layers and Date2Vec; with GMAN also its gman.*
spans inside engine.st_gnn): host ms and device ms (the
spans' CUDA events) per forward; the top kernels by device time; and the
device's busy share of the wall time (the union of kernel intervals per
forward ÷ wall, so overlapping kernels count once; the rest is the device
idle, waiting on the host). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_serve_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from multimodal_outage_tpu_torch.core import tracing
    from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.serving import ServingModel
    from multimodal_outage_tpu_torch.weights import init_variables
    from outage_bench.trace import union_length

    ap = argparse.ArgumentParser()
    ap.add_argument("--st_gnn", choices=("gwnet", "dcrnn", "gman"), default="gwnet")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", type=str, default=None, help="also write the report as JSON here")
    ap.add_argument("--gwnet_kernel_size", type=int, default=1)
    ap.add_argument("--no_gcn", action="store_true")
    args = ap.parse_args()

    cfg = ModelConfig(st_gnn=args.st_gnn, gwnet=GWNetConfig(kernel_size=args.gwnet_kernel_size,
                                                            gcn_bool=not args.no_gcn))
    serve = ServingModel(cfg, init_variables(cfg, 7, 67, seed=0), model_supports(cfg, 67))
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {"device": torch.cuda.get_device_name(0), "card": card, "st_gnn": args.st_gnn,
              "gwnet_kernel_size": args.gwnet_kernel_size, "gcn_bool": not args.no_gcn,
              "gwnet_stack": serve.gwnet_stack}
    for b in args.batch:
        x = torch.randn(b, 67, 7, 128, 128, 1, generator=gen, device="cuda").to(torch.bfloat16)
        feats = torch.tensor([0, 0, 0, 2018, 10, 1], dtype=torch.float32,
                             device="cuda").repeat(b, 7, 1)
        for _ in range(3):
            serve(x, feats)
        torch.cuda.synchronize()
        walls = []
        for _ in range(args.repeats):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            serve(x, feats)
            end.record()
            end.synchronize()
            walls.append(start.elapsed_time(end))
        walls.sort()
        wall = walls[len(walls) // 2]
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        tracing.clear()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.repeats):
                serve(x, feats)
            torch.cuda.synchronize()
        spans = tracing.spans()
        tracing.clear()
        per_kernel, intervals = defaultdict(float), []
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                per_kernel[ev.name()] += ev.duration_ns() / 1e6 / args.repeats
                intervals.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        stages = defaultdict(lambda: {"host_ms": 0.0, "device_ms": 0.0})
        for sp in spans:
            stages[sp.name]["host_ms"] += sp.host_ms / args.repeats
            stages[sp.name]["device_ms"] += (sp.device_ms or 0.0) / args.repeats
        root = stages.pop("engine.forward")
        stages["engine.forward (own)"] = {
            "host_ms": root["host_ms"] - sum(v["host_ms"] for k, v in stages.items()
                                             if k.startswith("engine."))}
        busy = union_length(intervals) / 1e6 / args.repeats
        row = {
            "batch": b, "wall_ms_p50": wall, "wall_ms_all": walls,
            "device_busy_ms": busy, "device_busy_share": busy / wall if busy else None,
            "forward_host_ms": root["host_ms"], "stages": dict(stages),
            "top_kernels_ms": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]),
        }
        report[f"B={b}"] = row
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
