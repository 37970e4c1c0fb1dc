"""The comparison that decides `correct`: what the timed path produced,
held to the plain reference (reference/model.py) on the same inputs.

Forecasts: for each sampled request, the relative RMS gap
||y - y_ref|| / ||y_ref|| and the largest gap max|y - y_ref| / max|y_ref|,
the worst request of the sample read.

Training: the reference follows the program's first three steps from the
same variables, windows and dropout stream. Compared are each step's loss
(relative gap), and per leaf the norm of the first gradient (the program's
from its Adam first moment after one step, mu / (1 - b1)) and the norm of
the parameters' change after three steps: |norm_prog - norm_ref| over the
larger of the leaf's reference norm and the median leaf's, the worst leaf
read. Leaves whose reference gradient is under a thousandth of the median
leaf's (a bias that BatchNorm cancels) are left out by that rule.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from outage_bench.inputs import flatten, unflatten
from outage_bench.reference import model as ref

B1, B2, EPS = 0.9, 0.999, 1e-8
NULL_GRAD = 1e-3  # of the median leaf's reference gradient norm


# --- forecasts ----------------------------------------------------------------

@torch.no_grad()
def reference_forecast(variables: Dict, model: Dict, batch: Dict, supports: torch.Tensor,
                       quant=ref.ident) -> torch.Tensor:
    """The reference forecast of a batch, one request row at a time."""
    rows = [ref.forward(variables, batch["x"][i:i + 1], batch["date_feats"][i:i + 1], supports,
                        model, quant=quant) for i in range(batch["x"].shape[0])]
    return torch.cat(rows)


def forecast_gaps(ys: Sequence[torch.Tensor], yrs: Sequence[torch.Tensor],
                  y16s: Sequence[torch.Tensor]) -> Dict[str, float]:
    """The worst sampled request's gaps between the served forecasts ys and
    the reference's yrs: relative (rel_rms, max_rel) and against the gap
    that bf16 operands give the reference on the same request (y16s), which
    takes out how far the seed's weights amplify rounding (rms_vs_bf16,
    max_vs_bf16)."""
    out = dict.fromkeys(("rel_rms", "max_rel", "rms_vs_bf16", "max_vs_bf16"), 0.0)
    for y, yr, y16 in zip(ys, yrs, y16s):
        d, d16 = y.float() - yr, y16 - yr
        for k, v in (("rel_rms", d.norm() / yr.norm()), ("max_rel", d.abs().max() / yr.abs().max()),
                     ("rms_vs_bf16", d.norm() / d16.norm()),
                     ("max_vs_bf16", d.abs().max() / d16.abs().max())):
            out[k] = max(out[k], float(v))
    return out


# --- training -----------------------------------------------------------------

def dropout_sites(model: Dict, b: int, n: int, t: int, size: int) -> List[Tuple[tuple, float]]:
    """(shape, rate) of each dropout draw of a train forward, in the
    program's order: the encoder's hidden layer, each Graph WaveNet layer's
    output, the decoder's hidden layer."""
    grid = size // 2 ** model["depth"]
    flat = grid * grid * model["base_channels"] * 2 ** model["depth"]
    cf, rate = model["compression_factor"], model["encoder_dropout"]
    sites = [((b, n, t, flat // cf), rate)]
    if model["st_gnn"] == "gwnet":
        g = model["gwnet"]
        sites += [((b, n, t, g["residual_channels"]), g["dropout"])] * (g["blocks"] * g["layers"])
    sites.append(((b, n, t, model["feature_vector_size"] * cf), rate))
    return sites


def dropout_masks(seed: int, step: int, sites, device) -> List[Tuple[torch.Tensor, float]]:
    """The program's dropout stream: one generator per (seed, step) on the
    device, seeded seed * 1_000_003 + step, a uniform draw per site in
    order, kept where below 1 - rate."""
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
    return [(torch.rand(shape, generator=g, device=device) < 1.0 - rate, 1.0 - rate)
            for shape, rate in sites]


def trainable(model: Dict, path: str) -> bool:
    return model["train_date2vec"] or not path.startswith("date2vec/")


def reference_train(variables: Dict, model: Dict, batches: Sequence[Dict], supports: torch.Tensor,
                    drop_seed: int, lrs: Sequence[float], rows_per_block: int,
                    quant=ref.ident, use_rows: Optional[int] = None) -> Dict:
    """The reference's steps from `variables`: {"loss": [per step],
    "grad1": {leaf: first gradient}, "change": {leaf: p_end - p_0}}. Each
    step's gradient is summed over blocks of rows (BatchNorm groups never
    span samples, so blocks change nothing). use_rows < B takes the mean
    over the first use_rows rows only (a fault the check must catch)."""
    p0 = {k: v.detach().float() for k, v in flatten(variables["params"]).items()}
    params = {k: v.clone().requires_grad_(trainable(model, k)) for k, v in p0.items()}
    stats = variables["batch_stats"]
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1 = [], {}
    for s, (batch, lr) in enumerate(zip(batches, lrs)):
        b, n, t = batch["x"].shape[:3]
        size = batch["x"].shape[3]
        masks = dropout_masks(drop_seed, s, dropout_sites(model, b, n, t, size), batch["x"].device)
        use = use_rows or b
        per_row = batch["y"][0].numel()
        total = 0.0
        for j0 in range(0, use, rows_per_block):
            j1 = min(j0 + rows_per_block, use)
            it = iter(masks)

            def drop(x, it=it, j0=j0, j1=j1):
                keep, kp = next(it)
                return torch.where(keep[j0:j1], x / kp, torch.zeros((), device=x.device))

            tree = {"params": unflatten(params), "batch_stats": stats}
            y = ref.forward(tree, batch["x"][j0:j1], batch["date_feats"][j0:j1], supports, model,
                            train=True, drop=drop, quant=quant)
            part = (y - batch["y"][j0:j1]).square().sum() / (use * per_row)
            part.backward()
            total += float(part.detach())
            del y, part
        losses.append(total)
        with torch.no_grad():
            for k, p in params.items():
                if p.grad is None:
                    continue
                if s == 0:
                    grad1[k] = p.grad.clone()
                mu[k].mul_(B1).add_(p.grad, alpha=1 - B1)
                nu[k].mul_(B2).addcmul_(p.grad, p.grad, value=1 - B2)
                c1, c2 = 1 - B1 ** (s + 1), 1 - B2 ** (s + 1)
                p.sub_(lr * ((mu[k] / c1) / ((nu[k] / c2).sqrt() + EPS)))
                p.grad = None
    change = {k: (params[k].detach() - p0[k]) for k in grad1}
    return {"loss": losses, "grad1": grad1, "change": change}


def leaf_gaps(prog: Dict[str, torch.Tensor], refd: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Per leaf |norm_prog - norm_ref| / max(norm_ref, the median leaf's)."""
    pn = {k: float(prog[k].float().norm()) for k in leaves}
    rn = {k: float(refd[k].float().norm()) for k in leaves}
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in leaves}


def counted_leaves(ref_grad1: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(v.norm()) for k, v in ref_grad1.items()}
    med = statistics.median(norms.values())
    return sorted(k for k, v in norms.items() if v >= NULL_GRAD * med)


def train_gaps(prog: Dict, refd: Dict) -> Dict[str, float]:
    """prog, refd: {"loss", "grad1", "change"} of the program and of the
    reference (or of a control or a fault in the program's place)."""
    leaves = counted_leaves(refd["grad1"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], refd["loss"]))
    grad = leaf_gaps(prog["grad1"], refd["grad1"], leaves).values()
    step = leaf_gaps(prog["change"], refd["change"], leaves).values()
    return {"loss_gap": loss, "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
            "step_gap": max(step), "step_gap_median": statistics.median(step)}


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, reading, limit)]): correct when every reading is a
    finite number within its limit; a limit with no reading fails."""
    rows = [(k, readings.get(k, float("nan")), float(lim)) for k, lim in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
