"""The plain reference against the program at test size on the CPU, and the
comparison that decides `correct` against its control and its faults: the
reference in float8 in the program's place, and the program broken
underneath a whole run (the look for a card skipped), must each come out
as not correct under the cells' committed limits.

    python -m pytest outage_bench/tests -q -p no:cacheprovider
    # on the card (marked): every cell once at full size, as run.py runs it
    python -m pytest outage_bench/tests -m cuda -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from outage_bench import check, spec
from outage_bench.drivers import DRIVERS
from outage_bench.reference import model as ref
from outage_bench.run import run_cell
from outage_bench.tests.tiny import tiny_cell

SEED = 2**31 + 4242
FORECASTS = ["dcrnn.forecast_b1", "gwnet.forecast_b1", "dcrnn.sweep_b16"]
CELLS = FORECASTS + ["gwnet.train_b16"]


@pytest.mark.parametrize("name", ["dcrnn.forecast_b1", "gwnet.forecast_b1"])
def test_reference_is_the_engine_in_float32(name):
    drv = DRIVERS["closed_loop"](tiny_cell(name), SEED, "cpu")
    drv.setup()
    for _ in range(3):
        drv.serve(drv.next_idx())
    for (_, y), r in zip(drv.sample, drv.reference()):
        assert float((y - r).norm() / r.norm()) < 1e-5


def test_reference_is_the_train_step_in_float32():
    drv = DRIVERS["train"](tiny_cell("gwnet.train_b16"), SEED, "cpu")
    drv.setup()
    gaps = check.train_gaps(drv.prog, drv.reference())
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4, gaps


def _bf16_cell(name):
    return tiny_cell(name, compute_dtype="bfloat16")


@pytest.mark.parametrize("name", FORECASTS)
def test_control_fails_the_forecast_limits(name):
    """The reference in float8 put in the program's place, against the
    reference, on the same sampled requests: not correct."""
    cell = _bf16_cell(name)
    drv = DRIVERS[cell.traffic["driver"]](cell, SEED, "cpu")
    drv.setup()
    drv.measure(0.3)
    yr, y16 = drv.reference(), drv.reference(ref.bf16)
    sound = check.forecast_gaps([y for _, y in drv.sample], yr, y16)
    control = check.forecast_gaps(drv.reference(ref.fp8), yr, y16)
    assert check.verdict(sound, cell.limits)[0], sound
    assert not check.verdict(control, cell.limits)[0], control


def test_control_and_half_batch_fail_the_train_limits():
    cell = _bf16_cell("gwnet.train_b16")
    drv = DRIVERS["train"](cell, SEED, "cpu")
    drv.setup()
    refd = drv.reference()
    assert check.verdict(check.train_gaps(drv.prog, refd), cell.limits)[0]
    for bad in (drv.reference(ref.fp8), drv.reference(use_rows=drv.b // 2)):
        assert not check.verdict(check.train_gaps(bad, refd), cell.limits)[0]


def _altered(y):
    """One county's forecast replaced by another's, where it is produced."""
    y = y.clone()
    y[:, 0] = y[:, 1]
    return y


def _half_left_out(y):
    """The second half of the batch's forecasts never computed."""
    y = y.clone()
    y[y.shape[0] // 2:] = 0.0
    return y


@pytest.mark.parametrize("name,fault", [(n, "altered") for n in FORECASTS]
                         + [("dcrnn.sweep_b16", "half")])
def test_a_broken_engine_is_not_correct(name, fault, monkeypatch):
    from multimodal_outage_tpu_torch import serving

    cell = tiny_cell(name)
    call = serving.ServingModel.__call__
    wrap = _altered if fault == "altered" else _half_left_out
    monkeypatch.setattr(serving.ServingModel, "__call__", lambda self, x, d: wrap(call(self, x, d)))
    assert run_cell(cell, SEED, 0.3, False, device="cpu")["correct"] is False


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from multimodal_outage_tpu_torch.train import state

    monkeypatch.setattr(state.Adam, "step", lambda self, lr: None)
    assert run_cell(tiny_cell("gwnet.train_b16"), SEED, 0.3, False, device="cpu")["correct"] is False


def test_a_step_over_half_the_batch_is_not_correct(monkeypatch):
    from multimodal_outage_tpu_torch.train import steps

    def half(model, batch, supports, gen, teacher, debug_nans, step):
        """The forward over the batch, the loss's mean over its first half."""
        yhat = model(batch["x"], batch["date_feats"], supports, train=True, generator=gen)
        b = yhat.shape[0] // 2
        torch.mean(torch.square(yhat[:b] - batch["y"][:b])).backward()
        return yhat.detach()

    monkeypatch.setattr(steps, "_forward_backward", half)
    assert run_cell(tiny_cell("gwnet.train_b16"), SEED, 0.3, False, device="cpu")["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_at_full_size_on_the_card(card, name):
    out = subprocess.run([sys.executable, "-m", "outage_bench.run", "--workload", name,
                          "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert np.isfinite([m["value"] for m in line["metrics"].values()]).all()
