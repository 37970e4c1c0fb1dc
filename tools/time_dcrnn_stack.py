#!/usr/bin/env python3
"""The DCRNN seq2seq kernel (kernel 5, ops/dcrnn_stack.py) in bf16 timed on
the card at full width (67 counties on the Florida graph's dual random walk,
T = horizon = 7, input 320, output 256, the default DCRNNConfig, random
weights from a seed), at each batch and at each split of a sample over a
cluster of C CTAs that fits:

  C             CTAs per sample (the plan's, or the one forced)
  active        clusters of C CTAs the card runs at once
  warm_ms       CUDA events around `reps` back-to-back calls, per call
  prof_ms       torch.profiler's device time of the kernel, per call
  err_ratio     max |kernel − float32 truth| ÷ max |plain bf16 − truth|
  rms_ratio     the same with the root mean square (the card tests hold
                them to 2.0 and 1.25)

    python3 tools/time_dcrnn_stack.py [--port_dir DIR] [--batch 1 16 17]
        [--reps 20] [--splits] [--out FILE]

--splits also forces each C that fits (16, 8, 4, 2, 1) in place of the
plan's, to measure what the plan chooses between. --port_dir imports the
port (multimodal_outage_tpu_torch) from DIR, the root of another checkout,
so that two versions of the kernel can be timed on one card in one call;
a port without the cluster plan gives the planned rows only. Prints the
card, then one JSON line per (batch, C). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

from _timing import Rows, device_ms, events_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_dcrnn_stack: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--port_dir", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16, 17])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--splits", action="store_true", help="also force each C that fits")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.port_dir))
    from multimodal_outage_tpu_torch import weights
    from multimodal_outage_tpu_torch.core.config import ModelConfig
    from multimodal_outage_tpu_torch.data.adjacency import model_supports
    from multimodal_outage_tpu_torch.ops import dcrnn_stack as dsm

    rows = Rows(args.port_dir, args.out)
    cfg = ModelConfig(st_gnn="dcrnn")
    d = cfg.dcrnn
    arch = dict(num_rnn_layers=d.num_rnn_layers, max_diffusion_step=d.max_diffusion_step,
                rnn_units=d.rnn_units)
    kw = dict(horizon=7, **arch)
    st = weights.init_variables(cfg, 7, 67, seed=1)["params"]["st_gnn"]
    sup32 = torch.from_numpy(model_supports(cfg, 67)).cuda()
    raw = dsm.dcrnn_stack_params(st, n_supports=sup32.shape[0], input_dim=cfg.st_gnn_in_dim,
                                 output_dim=cfg.feature_vector_size, **arch)
    sp, sp32 = dsm.stack_params_to(raw, "cuda", torch.bfloat16), dsm.stack_params_to(
        raw, "cuda", torch.float32)
    sup = sup32.to(torch.bfloat16).contiguous()
    shapes = (67, d.num_rnn_layers, sup.shape[0], d.max_diffusion_step, cfg.st_gnn_in_dim,
              cfg.feature_vector_size, d.rnn_units)
    gen = torch.Generator(device="cuda").manual_seed(0)
    planned = getattr(dsm, "_plan", None)

    for b in args.batch:
        x = torch.randn(b, 67, 7, cfg.st_gnn_in_dim, generator=gen, device="cuda").to(torch.bfloat16)
        fn = lambda: dsm.dcrnn_stack_forward(x, sup, sp, **kw)  # noqa: E731
        want = dsm.stack_forward_reference(x, sup, sp, **kw).float()
        truth = dsm.stack_forward_reference(x.float(), sup32, sp32, **kw)
        e_want = (want - truth).abs()
        splits = [None]
        if planned is not None and args.splits:
            splits += [c for c in (16, 8, 4, 2, 1)
                       if dsm.cluster_layout(*shapes, c) is not None]
        for c in splits:
            row = {"B": b}
            if planned is not None:
                lay = planned(b, *shapes, x.device)
                if c is not None:
                    lay = dsm.cluster_layout(*shapes, c)
                    ints = dsm.plan_ints(lay)
                    lay["ints"] = (dsm.ctypes.c_int * len(ints))(*ints)
                    dsm._plan = lambda *a, _lay=lay: _lay  # noqa: E731
                active = {}
                for cc in (16, 8, 4, 2, 1):
                    lc = dsm.cluster_layout(*shapes, cc)
                    if lc is not None:
                        n = dsm.ctypes.c_int(0)
                        dsm._lib().dcrnn_stack_max_clusters(cc, lc["total"], dsm.ctypes.byref(n))
                        active[cc] = n.value
                row.update({"C": lay["C"], "forced": c is not None, "active": active.get(lay["C"]),
                            "smem": lay["total"]})
            got = fn().float()
            torch.cuda.synchronize()
            e_got = (got - truth).abs()
            row.update({
                "warm_ms": events_ms(fn, args.reps),
                "prof_ms": device_ms(fn, args.reps, "dcrnn_stack_kernel"),
                "err_ratio": float(e_got.max() / e_want.max()),
                "rms_ratio": float(e_got.square().mean().sqrt() / e_want.square().mean().sqrt()),
            })
            if planned is not None:
                dsm._plan = planned
            rows.emit(row)
    return rows.write()


if __name__ == "__main__":
    sys.exit(main())
