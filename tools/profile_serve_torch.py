#!/usr/bin/env python3
"""Where the time of one serving forward of the PyTorch port goes, on the
card: full width (67 counties × 7 days × 128² frames, bf16, random
weights from a seed), at each requested batch size, with Graph WaveNet
or DCRNN as the st-GNN.

    python3 tools/profile_serve_torch.py [--st_gnn gwnet|dcrnn] [--batch 1 16]
        [--repeats 5] [--out FILE] [--gwnet_kernel_size K] [--no_gcn]

--gwnet_kernel_size > 1 or --no_gcn profile a non-fused Graph WaveNet,
which the engine serves through its eval-mode module (models/gwnet.py),
not the stack kernel.

Prints per batch size the forward's wall time (CUDA events, after a
warm-up), then torch.profiler's device time per kernel name summed over
the profiled forwards and divided by their count, grouped into the
serving path's layers, and the device's busy share of the wall time
(device kernel time ÷ wall time; the rest is the device idle, waiting on
the host). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

# kernel-name fragments → the layer of the serving path they belong to
LAYERS = (
    ("double_conv_kernel", "DoubleConv kernel"),
    ("gwnet_stack_kernel", "Graph WaveNet stack kernel"),
    ("dcrnn_stack_kernel", "DCRNN stack kernel"),
    ("max_pool", "max-pool"),
    ("conv_transpose", "ConvTranspose (cuDNN)"),
    ("dgrad", "ConvTranspose (cuDNN)"),
    ("fprop", "temporal conv1d (cuDNN)"),
    ("convolve", "temporal conv1d (cuDNN)"),
    ("gemm", "Dense / 1x1 head (cuBLAS)"),
    ("gemv", "Dense / 1x1 head (cuBLAS)"),
    ("cutlass", "Dense / 1x1 head (cuBLAS)"),
    ("cat", "concat / copy / cast"),
    ("copy", "concat / copy / cast"),
    ("elementwise", "elementwise (bias, ReLU, casts)"),
)


def layer_of(name: str) -> str:
    low = name.lower()
    for frag, layer in LAYERS:
        if frag.lower() in low:
            return layer
    return "other"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_serve_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.serving import ServingModel
    from multimodal_outage_tpu_torch.weights import init_variables

    ap = argparse.ArgumentParser()
    ap.add_argument("--st_gnn", choices=("gwnet", "dcrnn"), default="gwnet")
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
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.repeats):
                serve(x, feats)
            torch.cuda.synchronize()
        per_kernel = defaultdict(float)
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                per_kernel[ev.name] += ev.time_range.elapsed_us() / 1e3 / args.repeats
        per_layer = defaultdict(float)
        for name, ms in per_kernel.items():
            per_layer[layer_of(name)] += ms
        busy = sum(per_kernel.values())
        row = {
            "batch": b, "wall_ms_p50": wall, "wall_ms_all": walls,
            "device_busy_ms": busy,
            "device_busy_share": busy / wall if busy else None,
            "layers_ms": dict(sorted(per_layer.items(), key=lambda kv: -kv[1])),
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
