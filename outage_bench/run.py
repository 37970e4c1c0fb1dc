"""Run one cell of the benchmark once, in this process, on the card:

    python3 -m outage_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start: imports, the card, the inputs made from the
seed, the program built and its kernels loaded or built, the cell's shapes
warmed) is `setup_s`; then the window runs for --seconds. With --trace 1
the cell's loop runs on under the profiler and the per-layer metrics are
read; with --trace 0 the end-to-end metrics are reported. Then the
program is freed and what it produced is held to the plain reference.
The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error, and the last key
of that object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# kernel and build caches of any library that keeps one, inside the checkout
# at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".bench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, ".bench_cache", "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float = T_START) -> Dict:
    """The cell's run: its result object (without the no-JAX check) and its
    readings."""
    import torch

    from outage_bench import check, readers
    from outage_bench.drivers import DRIVERS

    cuda = torch.device(device).type == "cuda"
    drv = DRIVERS[cell.traffic["driver"]](cell, seed, device)
    drv.setup()
    stages = [("imports", drv.marks[0][1] - t_start)] + [
        (name, t - t0) for (_, t0), (name, t) in zip(drv.marks, drv.marks[1:])]
    readers.note("set-up " + ", ".join(f"{name} {s:.2f} s" for name, s in stages))
    # set-up's objects leave the collector's scans, so that a collection in
    # the window costs what the window's own objects cost
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    e2e = drv.measure(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    name = torch.cuda.get_device_name() if cuda else "cpu"
    segment = drv.segment(cell.traffic["trace_seconds"]) if trace else None
    metrics: Dict[str, Dict] = {}
    if trace:
        ctx = readers.Context(cell, drv, segment, name)
        from outage_bench.spec import reader

        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is None:
                readers.note(f"{m['name']}: nothing to read in this run, left out")
            else:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
            else:
                readers.note(f"{m['name']}: not measured by this cell's driver")
    attempted = drv.window["units"]
    readings = drv.check()
    ok, rows = check.verdict(readings, cell.limits)
    result = {
        "correct": ok, "attempted": attempted, "failed": 0, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": cell.chips if cuda else 0, "memory_peak_bytes": int(peak)},
    }
    if cuda:
        result["device"]["power_limit_w"] = power_limit_w()
    if trace:
        result["device"]["busy_s"] = segment.busy_s
        result["device"]["window_s"] = segment.window_s
        result["breakdown"] = segment.breakdown()
    result["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for k, v, lim in rows}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from outage_bench import nojax, spec

    if not torch.cuda.is_available():
        print("outage_bench: no CUDA device; the benchmark runs on the card only", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"outage_bench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = nojax.loaded()
    if bad:
        print(f"outage_bench: the run loaded {bad}: nothing it runs may import JAX or the "
              "JAX package", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
