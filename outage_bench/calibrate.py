"""Readings to set the correctness limits from (not run by the benchmark's
own runs): for each seed, the sound program's readings at the cell's own
size and load, and those of the lower-precision control (the reference with
every product in float8 e4m3 put in the program's place) on the same
inputs; for a training cell also the fault of half the batch left out.
One process for all seeds: set-up is paid once for the imports and the
kernels.

    python3 -m outage_bench.calibrate --workload <cell> --seconds 2 --seeds 1 2 3 ...

Prints one JSON line per seed and reading kind.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from outage_bench import check, spec
from outage_bench.drivers import DRIVERS
from outage_bench.reference import model as ref


def worst(gaps: dict, k: int = 4) -> list:
    return sorted(((v, n) for n, v in gaps.items()), reverse=True)[:k]


def train_detail(prog: dict, refd: dict) -> dict:
    leaves = check.counted_leaves(refd["grad1"])
    return {"grad_worst": worst(check.leaf_gaps(prog["grad1"], refd["grad1"], leaves)),
            "step_worst": worst(check.leaf_gaps(prog["change"], refd["change"], leaves)),
            "loss": [prog["loss"], refd["loss"]],
            "excluded": sorted(set(refd["grad1"]) - set(leaves))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--no_control", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        drv = DRIVERS[cell.traffic["driver"]](cell, seed, "cuda")
        drv.setup()
        drv.measure(args.seconds)
        rows = []
        if cell.traffic["driver"] == "train":
            refd = drv.reference()
            rows.append(("program", check.train_gaps(drv.prog, refd), train_detail(drv.prog, refd)))
            if not args.no_control:
                ctl = drv.reference(quant=ref.fp8)
                rows.append(("control_fp8", check.train_gaps(ctl, refd), train_detail(ctl, refd)))
                half = drv.reference(use_rows=drv.b // 2)
                rows.append(("fault_half_batch", check.train_gaps(half, refd), None))
        else:
            yr, y16 = drv.reference(), drv.reference(ref.bf16)
            rows.append(("program", check.forecast_gaps([y for _, y in drv.sample], yr, y16), None))
            if not args.no_control:
                yc = drv.reference(quant=ref.fp8)
                rows.append(("control_fp8", check.forecast_gaps(yc, yr, y16), None))
        for kind, readings, detail in rows:
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                              "readings": readings, "detail": detail}), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
