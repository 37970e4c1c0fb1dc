"""Readings to set the correctness limits from (not run by the benchmark's
own runs): for each seed, the sound program's readings at the cell's own
size and load, and those of the lower-precision control (the reference with
every product in float8 e4m3 put in the program's place) on the same
inputs; for a training cell also the faults of half the batch left out
and of a step that leaves its state unchanged, with scheduled sampling the
teacher ignored (every coin tails: in the reference, and in the program,
set up anew), and the bf16 yardstick's own gaps.
One process for all seeds: set-up is paid once for the imports and the
kernels.

    python3 -m outage_bench.calibrate --workload <cell> --seconds 2 --seeds 1 2 3 ...

Prints one JSON line per seed and reading kind.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from outage_bench import check, spec
from outage_bench.drivers import DRIVERS
from outage_bench.reference import model as ref


def worst(gaps: dict, k: int = 4) -> list:
    return sorted(((v, n) for n, v in gaps.items()), reverse=True)[:k]


def leaf_vec_gaps(prog: dict, refd: dict, leaves: list) -> dict:
    """Per leaf ||g_prog - g_ref|| / max(norm_ref, the median leaf's): the
    gap of the whole vector."""
    rn = {k: float(refd[k].float().norm()) for k in leaves}
    med = statistics.median(rn.values())
    return {k: float((prog[k].to(refd[k].device).float() - refd[k].float()).norm()) / max(rn[k], med)
            for k in leaves}


def train_detail(prog: dict, refd: dict) -> dict:
    """The worst leaves, the losses, the leaves left out, and every counted
    leaf's gaps (grad, step, then each step's gradient vector) beside its
    reference norms."""
    leaves = check.counted_leaves(refd["grad1"])
    grad = check.leaf_gaps(prog["grad1"], refd["grad1"], leaves)
    step = check.leaf_gaps(prog["change"], refd["change"], leaves)
    vec = [leaf_vec_gaps(a, r, leaves) for a, r in zip(prog["grads"], refd["grads"])]
    return {"grad_worst": worst(grad), "step_worst": worst(step),
            "vec_worst": [worst(v) for v in vec],
            "loss": [prog["loss"], refd["loss"]],
            "excluded": sorted(set(refd["grad1"]) - set(leaves)),
            "leaves": {k: [grad[k], step[k], float(refd["grad1"][k].norm()),
                           float(refd["change"][k].norm())] + [v[k] for v in vec]
                       for k in leaves}}


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

        def timed(fn, *a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            return out, time.perf_counter() - t0

        if cell.traffic["driver"] == "train":
            refd, sec = timed(drv.reference)
            yard, ysec = timed(drv.reference, quant=ref.bf16)
            faults = [("program", drv.prog, sec)]
            if not args.no_control:
                faults.append(("control_fp8",) + timed(drv.reference, quant=ref.fp8))
                faults.append(("fault_half_batch",) + timed(drv.reference, use_rows=drv.b // 2))
                still, ssec = timed(drv.reference, lr=0.0)
                # the optimizer's state unchanged too: no first moment, no change
                zero = {k: torch.zeros_like(v) for k, v in still["grad1"].items()}
                faults.append(("fault_state_unchanged",
                               {"loss": still["loss"], "grad1": zero,
                                "grads": [zero] * len(still["grads"]), "change": zero}, ssec))
            untaught = None
            if ref.teacher(drv.model) is not None:
                untaught, usec = timed(drv.reference, heads=lambda c: [False] * len(c))
                faults.append(("fault_teacher_ignored", untaught, usec))
                # the same fault planted in the program: its decoder fed its own output
                with drv.program.teacher_ignored():
                    bad = DRIVERS[cell.traffic["driver"]](cell, seed, "cuda")
                    bad.setup()
                    faults.append(("fault_teacher_ignored_program", bad.prog, 0.0))
                    bad.free_program()
            faults.append(("yardstick_bf16", yard, ysec))
            for kind, run, sec in faults:
                rows.append((kind, check.train_gaps(run, refd, yard, untaught),
                             train_detail(run, refd), sec))
        else:
            (yr, y16), sec = timed(lambda: (drv.reference(), drv.reference(ref.bf16)))
            rows.append(("program", check.forecast_gaps([y for _, y in drv.sample], yr, y16), None,
                         sec))
            if not args.no_control:
                yc, sec = timed(drv.reference, quant=ref.fp8)
                rows.append(("control_fp8", check.forecast_gaps(yc, yr, y16), None, sec))
        for kind, readings, detail, sec in rows:
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                              "readings": readings, "detail": detail, "reference_s": sec}),
                  flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
