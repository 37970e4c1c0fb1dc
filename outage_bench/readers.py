"""What the per-layer metric files (metrics/<name>.py) share. Each file is a
read(ctx) that returns its number or None where the run has nothing for it
to read (the harness then leaves the metric out of the line). A share of a
roofline or of a peak is never returned as 0 for want of a reading.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

import torch

from outage_bench import counts, inputs
from outage_bench.reference import model as ref


class Context:
    """One run as the readers see it: the cell, the measured window
    (`window`: units done, seconds, spans), the traced segment (`trace`)
    and the card's peaks (None off the H100)."""

    def __init__(self, cell, driver, trace, device_name: str):
        self.cell, self.window, self.trace = cell, driver.window, trace
        self.model, self.data = cell.config["model"], cell.config["data"]
        self.batch = driver.b
        self.n_static = driver.supports.shape[0]
        self.train = cell.traffic["driver"] == "train"
        self.peaks = counts.peaks(device_name)
        self._flops: Optional[float] = None

    @property
    def shape(self):
        d = self.data
        return self.batch, d["n_counties"], d["horizon"], d["image_size"]

    def flops_per_unit(self) -> float:
        """Operations of one forward (or train step: forward and backward,
        and with scheduled sampling the teacher's eval-mode pass over the
        targets) at the cell's shapes, counted over the plain reference."""
        if self._flops is None:
            b, n, t, s = self.shape
            meta = lambda *shape: torch.empty(shape, device="meta")
            var = inputs.unflatten({p: meta(*shape) for p, shape, _ in
                             inputs.variables_layout(self.model, n, s, self.n_static)})
            x, feats, sup = meta(b, n, t, s, s, 1), meta(b, t, 6), meta(self.n_static, n, n)

            def fwd():
                if not self.train:
                    return ref.forward(var, x, feats, sup, self.model)
                leaves = [v.requires_grad_() for v in _leaves(var["params"])]
                teacher = None
                if ref.teacher(self.model) is not None:  # the step's eval-mode teacher pass
                    with torch.no_grad():
                        latent = ref.teacher_latent(var, x, self.model)
                    teacher = {"latent": latent, "heads": [False] * t}
                y = ref.forward(var, x, feats, sup, self.model, train=True, drop=lambda v: v,
                                teacher=teacher)
                y.square().mean().backward()
                return leaves

            self._flops = counts.reference_flops(fwd)
        return self._flops


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def note(msg: str) -> None:
    print(f"outage_bench: {msg}", file=sys.stderr)


def kernel_roofline(ctx: Context, patterns: Sequence[str], bound_per_unit: Callable[[], float],
                    launches_per_unit: int) -> Optional[float]:
    """% of the kernel's bound: bound per forward x forwards caught /
    device seconds of the kernels whose name holds a pattern."""
    if ctx.trace is None or ctx.peaks is None:
        return None
    sec, launches = ctx.trace.kernel_s(patterns)
    if launches == 0:
        note(f"no kernel named like {list(patterns)} in the traced window")
        return None
    return 100.0 * bound_per_unit() * (launches / launches_per_unit) / sec


def mfu(ctx: Context) -> Optional[float]:
    """% of the bf16 dense peak: operations per forward or step x those done
    in the measured window / its seconds / the peak."""
    if ctx.peaks is None or not ctx.window.get("units"):
        return None
    rate = ctx.flops_per_unit() * ctx.window["units"] / ctx.window["seconds"]
    return 100.0 * rate / ctx.peaks[0]


def device_idle(ctx: Context) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mean_span(ctx: Context, key: str) -> Optional[float]:
    vals = ctx.window.get(key)
    return sum(vals) / len(vals) if vals else None


def double_conv_bound(ctx: Context) -> float:
    b, n, t, s = ctx.shape
    m = b * n * t
    return sum(counts.bound_s(counts.double_conv_flops(m, h, w, ci, c),
                              counts.double_conv_bytes(m, h, w, ci, c, 2), ctx.peaks)
               for h, w, ci, c in counts.double_conv_shapes(ctx.model, s))
