"""The comparison that decides `correct`: what the timed path produced,
held to the plain reference (reference/model.py) on the same inputs.

Forecasts: for each sampled request, the relative RMS gap
||y - y_ref|| / ||y_ref|| and the largest gap max|y - y_ref| / max|y_ref|,
the worst request of the sample read.

Training: the reference follows the program's first three steps from the
same variables, windows, dropout stream and scheduled-sampling coins.
Compared are each step's loss (relative gap), and per leaf the norm of the
first gradient (the program's from its Adam first moment after one step,
mu / (1 - b1)) and the norm of the parameters' change after three steps:
|norm_prog - norm_ref| over the larger of the leaf's reference norm and the
median leaf's, the worst leaf read. Leaves whose reference gradient is under
a thousandth of the median leaf's (a bias that BatchNorm cancels) are left
out by that rule.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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
    program's order: the encoder's hidden layer, the st-GNN's own (its
    family's), the decoder's hidden layer."""
    grid = size // 2 ** model["depth"]
    flat = grid * grid * model["base_channels"] * 2 ** model["depth"]
    cf, rate = model["compression_factor"], model["encoder_dropout"]
    return ([((b, n, t, flat // cf), rate)] + ref.family(model).dropout_sites(model, b, n, t)
            + [((b, n, t, model["feature_vector_size"] * cf), rate)])


def dropout_masks(seed: int, step: int, sites, device) -> List[Tuple[torch.Tensor, float]]:
    """The program's dropout stream: one generator per (seed, step) on the
    device, seeded seed * 1_000_003 + step, a uniform draw per site in
    order, kept where below 1 - rate."""
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
    return [(torch.rand(shape, generator=g, device=device) < 1.0 - rate, 1.0 - rate)
            for shape, rate in sites]


def coins(seed: int, step: int, p0: float, tau: int, horizon: int) -> List[bool]:
    """The program's scheduled-sampling coins of one step: the probability
    p0 tau / (tau + e^(step / tau)) in float32 (p0 where tau <= 0) at the
    step count before it increments; a CPU generator per (seed, step),
    seeded from SeedSequence([seed, step, 0x5A]); heads where a uniform
    draw per decoder step is below it."""
    p = np.float32(p0)
    if tau > 0:
        tf = np.float32(tau)
        p = p * tf / (tf + np.exp(np.float32(step) / tf))
    state = np.random.SeedSequence([seed, step, 0x5A]).generate_state(1)[0]
    g = torch.Generator().manual_seed(int(state))
    return (torch.rand(horizon, generator=g) < float(p)).tolist()


def trainable(model: Dict, path: str) -> bool:
    return model["train_date2vec"] or not path.startswith("date2vec/")


def _clone(tree: Dict) -> Dict:
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def reference_train(variables: Dict, model: Dict, batches: Sequence[Dict], supports: torch.Tensor,
                    drop_seed: int, lrs: Sequence[float], rows_per_block: int,
                    quant=ref.ident, use_rows: Optional[int] = None,
                    heads: Optional[Callable[[List[bool]], List[bool]]] = None) -> Dict:
    """The reference's steps from `variables`: {"loss": [per step],
    "grad1": {leaf: first gradient}, "grads": [{leaf: gradient} per step],
    "change": {leaf: p_end - p_0}}. Each
    step's gradient is summed over blocks of rows (BatchNorm groups never
    span samples, so blocks change nothing). use_rows < B takes the mean
    over the first use_rows rows only (a fault the check must catch).

    With the st-GNN's scheduled sampling on, each step first runs the
    train-mode contraction over its rows to update the running BatchNorm
    statistics as the program's train pass does, computes the latent
    targets with them (model.teacher_latent), and feeds them where the
    step's coin (`coins`) is heads; `heads` maps a step's coins to those
    used (a fault the check must catch: every coin tails)."""
    p0 = {k: v.detach().float() for k, v in flatten(variables["params"]).items()}
    params = {k: v.clone().requires_grad_(trainable(model, k)) for k, v in p0.items()}
    stats = variables["batch_stats"]
    sched = ref.teacher(model)
    if sched is not None:
        stats = _clone(stats)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grads = [], []
    for s, (batch, lr) in enumerate(zip(batches, lrs)):
        b, n, t = batch["x"].shape[:3]
        size = batch["x"].shape[3]
        masks = dropout_masks(drop_seed, s, dropout_sites(model, b, n, t, size), batch["x"].device)
        use = use_rows or b
        per_row = batch["y"][0].numel()
        blocks = [(j0, min(j0 + rows_per_block, use)) for j0 in range(0, use, rows_per_block)]
        teach = None
        if sched is not None:
            tree = {"params": unflatten(params), "batch_stats": stats}
            with torch.no_grad():
                record: List = []
                for j0, j1 in blocks:
                    ref.contraction(batch["x"][j0:j1].float(), tree["params"]["contraction"],
                                    stats["contraction"], model["depth"], True, quant, record)
                ref.running_stats(record)
                del record
                latent = torch.cat([ref.teacher_latent(tree, batch["y"][j0:j1], model, quant)
                                    for j0, j1 in blocks])
            c = coins(drop_seed, s, *sched, batch["y"].shape[2])
            teach = {"latent": latent, "heads": heads(c) if heads else c}
        total = 0.0
        for j0, j1 in blocks:
            it = iter(masks)

            def drop(x, it=it, j0=j0, j1=j1):
                keep, kp = next(it)
                return torch.where(keep[j0:j1], x / kp, torch.zeros((), device=x.device))

            tree = {"params": unflatten(params), "batch_stats": stats}
            part_teach = None if teach is None else dict(teach, latent=teach["latent"][j0:j1])
            y = ref.forward(tree, batch["x"][j0:j1], batch["date_feats"][j0:j1], supports, model,
                            train=True, drop=drop, quant=quant, teacher=part_teach)
            part = (y - batch["y"][j0:j1]).square().sum() / (use * per_row)
            part.backward()
            total += float(part.detach())
            del y, part
        losses.append(total)
        with torch.no_grad():
            grads.append({k: p.grad.clone() for k, p in params.items() if p.grad is not None})
            for k, p in params.items():
                if p.grad is None:
                    continue
                mu[k].mul_(B1).add_(p.grad, alpha=1 - B1)
                nu[k].mul_(B2).addcmul_(p.grad, p.grad, value=1 - B2)
                c1, c2 = 1 - B1 ** (s + 1), 1 - B2 ** (s + 1)
                p.sub_(lr * ((mu[k] / c1) / ((nu[k] / c2).sqrt() + EPS)))
                p.grad = None
    change = {k: (params[k].detach() - p0[k]) for k in grads[0]}
    return {"loss": losses, "grad1": grads[0], "grads": grads, "change": change}


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


def teacher_gap_ratio(prog: Dict, refd: Dict, yard: Dict, untaught: Dict,
                      leaves: Sequence[str]) -> float:
    """Does the program follow the teacher? Over the (step, leaf) pairs where
    the teacher moves the reference's gradient by more than bf16 rounding
    does (||g_ref - g_untaught|| > ||g_bf16 - g_ref||; all pairs where none
    does), the root of the summed squared gaps of the program's gradient to
    the reference's over those to the untaught reference's (every coin
    tails), each leaf scaled by max(its reference norm, the median leaf's).
    Under 1 where the program is nearer the reference that feeds the
    teacher, over 1 where it is nearer the one that does not."""
    pairs, every = [], []
    for a, r, w, u in zip(prog["grads"], refd["grads"], yard["grads"], untaught["grads"]):
        rn = {k: float(r[k].norm()) for k in leaves}
        med = statistics.median(rn.values())
        for k in leaves:
            scale = max(rn[k], med)
            d_with = float((a[k].to(r[k].device).float() - r[k]).norm()) / scale
            d_without = float((a[k].to(r[k].device).float() - u[k]).norm()) / scale
            every.append((d_with, d_without))
            if float((r[k] - u[k]).norm()) > float((w[k] - r[k]).norm()):
                pairs.append((d_with, d_without))
    num, den = (sum(x * x for x in col) for col in zip(*(pairs or every)))
    return math.sqrt(num / den) if den > 0 else (0.0 if num == 0 else math.inf)


def train_gaps(prog: Dict, refd: Dict, yard: Optional[Dict] = None,
               untaught: Optional[Dict] = None) -> Dict[str, float]:
    """prog, refd: {"loss", "grad1", "change"} (and "grads") of the program and of the
    reference (or of a control or a fault in the program's place). With
    yard, the reference's steps with bf16 operands, also loss_gap,
    grad_gap_median and step_gap_median over the yardstick's own
    (loss_vs_bf16, grad_vs_bf16, step_vs_bf16): the program's gap against
    the rounding of its compute dtype, as far as this seed's weights
    amplify both. With untaught too, the reference's steps with every
    scheduled-sampling coin tails, and each step's gradients ("grads") on
    every side, teacher_gap_ratio: it sees the teacher fed or not where no
    norm moves past rounding."""
    leaves = counted_leaves(refd["grad1"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], refd["loss"]))
    grad = leaf_gaps(prog["grad1"], refd["grad1"], leaves).values()
    step = leaf_gaps(prog["change"], refd["change"], leaves).values()
    out = {"loss_gap": loss, "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
           "step_gap": max(step), "step_gap_median": statistics.median(step)}
    if yard is not None:
        y = train_gaps(yard, refd)
        for name, key in (("loss", "loss_gap"), ("grad", "grad_gap_median"),
                          ("step", "step_gap_median")):
            out[f"{name}_vs_bf16"] = (out[key] / y[key] if y[key] > 0
                                      else 0.0 if out[key] == 0 else math.inf)
        if untaught is not None and all("grads" in d for d in (prog, refd, yard, untaught)):
            out["teacher_gap_ratio"] = teacher_gap_ratio(prog, refd, yard, untaught, leaves)
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, reading, limit)]): correct when every reading is a
    finite number within its limit; a limit with no reading fails."""
    rows = [(k, readings.get(k, float("nan")), float(lim)) for k, lim in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
