#!/usr/bin/env python3
"""The U-Net's four up levels timed on the card at the *_fl67 widths (16²
64→32, 32² 32→16, 64² 16→8, 128² 8→4; skip C channels, low-resolution
map 2C), bf16, at each batch (M = 67·7·B frames), two ways:

  four_ops      F.conv_transpose2d → torch.cat → kernel 1, as the serving
                engine runs a level the up form does not take
  up_form       kernel 1's up form (ops/double_conv.py
                fused_up_double_conv), one launch

Per (level, B, way) one JSON line:

  prof_ms       torch.profiler's device time of every kernel the call
                launched, per call
  kernel1_ms    of it, the kernels named like double_conv_kernel
  launches      kernels a call launched
  tile, smem    the up form's tile and shared bytes (its plan's, or the
                ones forced with --tiles)
  err_ratio     max |result − float32 truth| ÷ max |four_ops − truth|
  rms_ratio     the same with the root mean square (the card tests hold
                them to 2.0 and 1.25)

    python3 tools/time_up_levels.py [--batch 1 16] [--reps 20] [--tiles]
        [--out FILE]

--tiles also forces each tile of _BF16_TILES that fits the up form, to
measure what its plan chooses between. Prints the card, then the lines.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

from _timing import Rows


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_up_levels: needs a CUDA card", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tiles", action="store_true", help="also force each tile that fits")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from multimodal_outage_tpu_torch.ops import double_conv as dcm

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def profile(fn):
        """(device ms a call, kernel 1's ms a call, kernels a call) over reps calls."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        ms = lambda es: sum(ev.time_range.elapsed_us() for ev in es) / 1e3 / args.reps
        return ms(evs), ms([ev for ev in evs if "double_conv_kernel" in ev.name]), \
            len(evs) / args.reps

    rows = Rows(root, args.out)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *s, k=1.0, dt=torch.bfloat16: (  # noqa: E731
        torch.randn(*s, generator=gen, device="cuda") * k).to(dt)
    planned = dcm.plan_bf16
    for h, cl, c in ((16, 64, 32), (32, 32, 16), (64, 16, 8), (128, 8, 4)):
        cin = 2 * c
        wt, bt = rand(cl, c, 2, 2, k=cl ** -0.5), rand(c, k=0.1)
        conv = (rand(3, 3, cin, c, k=(2 / (9 * cin)) ** 0.5), rand(c, dt=torch.float32).abs() + 0.5,
                rand(c, k=0.1, dt=torch.float32), rand(3, 3, c, c, k=(2 / (9 * c)) ** 0.5),
                rand(c, dt=torch.float32).abs() + 0.5, rand(c, k=0.1, dt=torch.float32))
        for b in args.batch:
            m = 67 * 7 * b
            skip, low = rand(m, h, h, c), rand(m, h // 2, h // 2, cl)

            def four_ops():
                y = F.conv_transpose2d(low.permute(0, 3, 1, 2), wt, bt, stride=2)
                return dcm.fused_double_conv(
                    torch.cat([skip, y.permute(0, 2, 3, 1)], -1).contiguous(), *conv)

            up = lambda: dcm.fused_up_double_conv(skip, low, wt, bt, *conv)  # noqa: E731
            truth = dcm.up_double_conv_reference(skip.float(), low.float(), wt.float(),
                                                 bt.float(), *(a.float() for a in conv))
            e_want = (four_ops().float() - truth).abs()
            tiles = [None]
            if args.tiles:
                tiles += [t for t in dict.fromkeys(
                    (min(th, h), min(tw, h)) for th, tw in dcm._BF16_TILES)
                          if dcm._bf16_smem(cin, c, *t, cl) <= dcm._SMEM_BUDGET]
            for way, fn, tile in [("four_ops", four_ops, None)] + [("up_form", up, t) for t in tiles]:
                row = {"H": h, "Cl": cl, "C": c, "B": b, "way": way}
                if way == "up_form":
                    plan = planned(m, h, h, cin, c, cl)
                    if tile is not None:
                        th, tw = tile
                        plan = plan._replace(th=th, tw=tw, smem=dcm._bf16_smem(cin, c, th, tw, cl),
                                             items=m * -(-h // th) * -(-h // tw))
                        dcm.plan_bf16 = lambda *a, _p=plan: _p  # noqa: E731
                    row.update({"tile": [plan.th, plan.tw], "smem": plan.smem,
                                "forced": tile is not None})
                try:
                    got = fn().float()
                    torch.cuda.synchronize()
                    e_got = (got - truth).abs()
                    prof_ms, k1_ms, launches = profile(fn)
                finally:
                    dcm.plan_bf16 = planned
                row.update({
                    "prof_ms": prof_ms, "kernel1_ms": k1_ms, "launches": launches,
                    "err_ratio": float(e_got.max() / e_want.max()),
                    "rms_ratio": float(e_got.square().mean().sqrt()
                                       / e_want.square().mean().sqrt()),
                })
                rows.emit(row)
            del skip, low, truth, e_want
            torch.cuda.empty_cache()
    return rows.write()


if __name__ == "__main__":
    sys.exit(main())
