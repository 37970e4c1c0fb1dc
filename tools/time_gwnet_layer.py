#!/usr/bin/env python3
"""The per-layer Graph WaveNet kernel (ops/gwnet_layer.py) timed on the
card at full width (67 counties, T=7, C = Cd = 32, Cs = 256, order 2,
S = 2: identity + the adaptive adjacency; random weights from a seed),
alone and inside a training step:

  warm_ms       CUDA events around `reps` back-to-back calls, per call
  cold_ms       CUDA events around each call, the 50 MB L2 flushed before
                it (a 128 MiB buffer zeroed), mean per call
  prof_ms       torch.profiler's device time of the kernel over `reps`
                back-to-back calls, per call
  prof_cold_ms  the same with the L2 flushed before each call
  forward_p50_ms, forward_p90_ms
                one bf16 ServingModel(gwnet_pallas=True) forecast at B = 1
                and 16 (the engine that runs this kernel 8 times a
                forward), CUDA events around each of 40 requests
                after a warm-up (serving.time_requests)
  forward_layer_ms
                torch.profiler's device time of the kernel's 8 calls in
                one such forward
  step_ms_p50   a full-width B=8 bf16 train step with
                GWNetConfig(use_pallas=True) and pool="pallas" (CUDA
                events, p50 over --steps steps after two warm-up steps)
  step_layer_ms torch.profiler's device time of the kernel inside those
                steps, per call (8 calls a step)

Every profiler time counts the kernel's launches and raises unless the
profile caught each of them (tools/_timing.py).

--sweep also times the bf16 body (prof_ms, B=8) at shapes around the
full-width one, random weights from a seed: diffusion order 1-4 (each
order one more phase of S·2·MT diffusion items), N = 16 (one m-tile: the
fixed part of the chain), and Cs = 64 (a quarter of the skip product).

    python3 tools/time_gwnet_layer.py [--port_dir DIR] [--batch 1 8 16]
        [--dtype bfloat16 float32] [--reps 50] [--steps 5] [--no_serve]
        [--no_step] [--sweep] [--out FILE]

--port_dir imports the port (multimodal_outage_tpu_torch) from DIR, the
root of another checkout, so that two versions of the kernel can be timed
on one card in one call: run the tool in turns on each (parent, change,
change, parent). Prints the card, then one JSON line per (dtype, batch),
per forecast batch and one for the train step. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

from _timing import Rows, device_ms, events_ms, events_ms_cold, flush_buffer


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_gwnet_layer: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--port_dir", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 8, 16])
    ap.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--no_serve", action="store_true", help="skip the serving forecasts")
    ap.add_argument("--no_step", action="store_true", help="skip the train step")
    ap.add_argument("--sweep", action="store_true", help="also time the bf16 body at other shapes")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.port_dir))
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.ops import gwnet_layer as glm
    from multimodal_outage_tpu_torch.ops import gwnet_stack as gsm
    from multimodal_outage_tpu_torch.serving import ServingModel, time_requests
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import make_train_step

    rows, flush = Rows(args.port_dir, args.out), flush_buffer()
    kernel = "gwnet_layer_kernel"

    cfg = ModelConfig()
    st = weights.init_variables(cfg, 7, 67, seed=1)["params"]["st_gnn"]
    names = [f"{k}0_{p}" for k in ("filter_conv", "gate_conv", "skip_conv", "gconv")
             for p in ("kernel", "bias")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dn in args.dtype:
        dtype = getattr(torch, dn)
        w = [st[k].to("cuda", dtype).contiguous() for k in names]
        sup = gsm.adaptive_supports(torch.eye(67, device="cuda")[None], st["nodevec1"].cuda(),
                                    st["nodevec2"].cuda(), dtype)
        for b in args.batch:
            x = torch.randn(b, 67, 7, 32, generator=gen, device="cuda").to(dtype)
            fn = lambda: glm.gwnet_layer_forward(x, sup, *w, order=cfg.gwnet.order)
            rows.emit({"dtype": dn, "B": b, "warm_ms": events_ms(fn, args.reps),
                       "cold_ms": events_ms_cold(fn, args.reps, flush),
                       "prof_ms": device_ms(fn, args.reps, kernel),
                       "prof_cold_ms": device_ms(fn, args.reps, kernel, flush)})
    if args.sweep:
        # (N, Cs, order) around the full-width (67, 256, 2), S = 2, C = Cd = 32
        for n, cs, order in ((67, 256, 1), (67, 256, 3), (67, 256, 4), (16, 256, 2),
                             (67, 64, 2)):
            nt = 2 * order + 1
            shapes = [(32, 32), (32,), (32, 32), (32,), (32, cs), (cs,), (nt * 32, 32), (32,)]
            w = [(torch.randn(*sh, generator=gen, device="cuda") / sh[0] ** 0.5)
                 .to(torch.bfloat16) for sh in shapes]
            sup = torch.softmax(torch.randn(2, n, n, generator=gen, device="cuda"), -1)
            sup = sup.to(torch.bfloat16)
            x = torch.randn(8, n, 7, 32, generator=gen, device="cuda").to(torch.bfloat16)
            fn = lambda: glm.gwnet_layer_forward(x, sup, *w, order=order)
            rows.emit({"dtype": "bfloat16", "B": 8, "N": n, "Cs": cs, "order": order,
                       "prof_ms": device_ms(fn, args.reps, kernel)})
    if not args.no_serve:
        serve = ServingModel(cfg, weights.init_variables(cfg, 7, 67, seed=0),
                             model_supports(cfg, 67), gwnet_stack=False, gwnet_pallas=True)
    for b in [] if args.no_serve else (1, 16):
        x = torch.randn(b, 67, 7, 128, 128, 1, generator=gen, device="cuda").to(torch.bfloat16)
        feats = torch.tensor([0, 0, 0, 2018, 10, 1], dtype=torch.float32,
                             device="cuda").repeat(b, 7, 1)
        walls = sorted(time_requests(serve, [{"x": x, "date_feats": feats}], 40))
        rows.emit({"dtype": "bfloat16", "B": b, "engine": "gwnet_pallas",
                   "forward_p50_ms": walls[len(walls) // 2],
                   "forward_p90_ms": walls[int(0.9 * (len(walls) - 1))],
                   "forward_layer_ms": device_ms(lambda: serve(x, feats), 10, kernel, per_call=8),
                   "requests": len(walls)})
    if args.no_step:
        return rows.write()

    cfg = ModelConfig(pool="pallas", gwnet=GWNetConfig(use_pallas=True))
    model = weights.load_variables(build_model(cfg, 7, 67, 128),
                                   weights.init_variables(cfg, 7, 67, seed=0))
    model.cuda()
    state, step = create_train_state(model), make_train_step(model)
    b = 8
    batch = {
        "x": torch.randn(b, 67, 7, 128, 128, 1, generator=gen, device="cuda").to(torch.bfloat16),
        "y": torch.randn(b, 67, 7, 128, 128, 1, generator=gen, device="cuda"),
        "date_feats": torch.tensor([0, 0, 0, 2018, 10, 1], dtype=torch.float32,
                                   device="cuda").repeat(b, 7, 1),
    }
    sup = torch.eye(67, device="cuda")[None]
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
    try:
        layer_ms = device_ms(lambda: step(state, batch, sup, 1e-3, 0), args.steps, kernel,
                             per_call=8) / 8
    except RuntimeError as e:  # the profiles lost launches: no mean from them
        layer_ms = str(e)
    rows.emit({"dtype": "bfloat16", "B": b, "step_ms_p50": sorted(walls)[len(walls) // 2],
               "step_ms_all": walls, "step_layer_ms": layer_ms, "steps": args.steps})
    return rows.write()


if __name__ == "__main__":
    sys.exit(main())
