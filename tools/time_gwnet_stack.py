#!/usr/bin/env python3
"""The Graph WaveNet stack kernel (ops/gwnet_stack.py) timed four ways on
the card, at full width (67 counties, T=7, the default GWNetConfig,
random weights from a seed), to tell its back-to-back time from the time
it takes inside a serving forward:

  warm_ms       CUDA events around `reps` back-to-back calls, per call
  cold_ms       CUDA events around each call, the 50 MB L2 flushed before
                it (a 128 MiB buffer zeroed), mean per call
  prof_ms       torch.profiler's device time of the kernel over `reps`
                back-to-back calls, per call
  prof_cold_ms  the same with the L2 flushed before each call
  forward_ms    torch.profiler's device time of the kernel inside
                `reps` bf16 serving forwards (ServingModel), per forward

    python3 tools/time_gwnet_stack.py [--port_dir DIR] [--batch 1 16]
        [--dtype bfloat16 float32] [--layers 8] [--reps 20] [--no_forward]
        [--out FILE]

--layers runs the kernel alone with that many Graph WaveNet layers
(GWNetConfig blocks = layers, 1 layer per block; the default config has
8), so that two counts split its time into a part per layer and a fixed
part (start projection, end convolutions); the forward always has 8.
--port_dir imports the port (multimodal_outage_tpu_torch) from DIR, the
root of another checkout, so that two versions of the kernel can be
timed on one card in one call. Prints the card, then one JSON line per
(dtype, batch) and per forward batch. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

from _timing import Rows, device_ms, events_ms, events_ms_cold, flush_buffer


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_gwnet_stack: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--port_dir", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--layers", type=int, nargs="+", default=[8])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no_forward", action="store_true", help="skip the serving forwards")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.port_dir))
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import GWNetConfig, ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.ops import gwnet_stack as gsm
    from multimodal_outage_tpu_torch.serving import ServingModel

    rows, flush = Rows(args.port_dir, args.out), flush_buffer()

    def times(fn) -> dict:
        return {"warm_ms": events_ms(fn, args.reps),
                "cold_ms": events_ms_cold(fn, args.reps, flush),
                "prof_ms": device_ms(fn, args.reps, "gwnet_stack_kernel"),
                "prof_cold_ms": device_ms(fn, args.reps, "gwnet_stack_kernel", flush)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n_layers, dn in [(n, dn) for n in args.layers for dn in args.dtype]:
        cfg = ModelConfig(gwnet=GWNetConfig(blocks=n_layers, layers=1))
        var = weights.init_variables(cfg, 7, 67, seed=1)
        st, st_bs = var["params"]["st_gnn"], var["batch_stats"]["st_gnn"]
        dtype = getattr(torch, dn)
        sp = {k: v.cuda() for k, v in gsm.stack_params_from_module(
            st, st_bs, n_layers, dtype).items()}
        if dtype == torch.bfloat16 and hasattr(gsm, "stack_fragments"):
            sp["frags"] = gsm.stack_fragments(sp)
        sup = gsm.adaptive_supports(torch.eye(67, device="cuda")[None], st["nodevec1"].cuda(),
                                    st["nodevec2"].cuda(), dtype)
        for b in args.batch:
            x = torch.randn(b, 67, 7, cfg.st_gnn_in_dim, generator=gen, device="cuda").to(dtype)
            fn = lambda: gsm.gwnet_stack_forward(x, sup, sp, order=cfg.gwnet.order)
            rows.emit({"dtype": dn, "B": b, "layers": n_layers, **times(fn)})
    cfg = ModelConfig()
    serve = ServingModel(cfg, weights.init_variables(cfg, 7, 67, seed=0), model_supports(cfg, 67))
    for b in [] if args.no_forward else args.batch:
        x = torch.randn(b, 67, 7, 128, 128, 1, generator=gen, device="cuda").to(torch.bfloat16)
        feats = torch.tensor([0, 0, 0, 2018, 10, 1], dtype=torch.float32,
                             device="cuda").repeat(b, 7, 1)
        fwd = lambda: serve(x, feats)
        rows.emit({"dtype": "bfloat16", "B": b, "forward_wall_ms": events_ms(fwd, args.reps),
                   "forward_ms": device_ms(fwd, args.reps, "gwnet_stack_kernel")})
    return rows.write()


if __name__ == "__main__":
    sys.exit(main())
