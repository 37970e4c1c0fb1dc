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
TRAINING = ["gwnet.train_b16", "dcrnn.train_b16_tf"]
CELLS = FORECASTS + TRAINING


@pytest.mark.parametrize("name", ["dcrnn.forecast_b1", "gwnet.forecast_b1"])
def test_reference_is_the_engine_in_float32(name):
    drv = DRIVERS["closed_loop"](tiny_cell(name), SEED, "cpu")
    drv.setup()
    for _ in range(3):
        drv.serve(drv.next_idx())
    for (_, y), r in zip(drv.sample, drv.reference()):
        assert float((y - r).norm() / r.norm()) < 1e-5


def _agrees(gaps):
    return gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4


@pytest.mark.parametrize("name", TRAINING)
def test_reference_is_the_train_step_in_float32(name):
    drv = DRIVERS["train"](tiny_cell(name), SEED, "cpu")
    drv.setup()
    gaps = check.train_gaps(drv.prog, drv.reference())
    assert _agrees(gaps), gaps


def test_reference_follows_the_teacher_coin_by_coin():
    """The program's DCRNN step with scheduled sampling (p0 0.5, tau 20,
    three steps, so that the coins fall both ways) is the reference's; with
    the coins flipped it is not."""
    cell = tiny_cell("dcrnn.train_b16_tf")
    cell.config["model"]["dcrnn"].update(teacher_forcing=0.5, tf_decay_steps=20)
    assert ref.teacher(cell.config["model"]) == (0.5, 20)
    drv = DRIVERS["train"](cell, SEED, "cpu")
    drv.setup()
    refd = drv.reference()
    assert _agrees(check.train_gaps(drv.prog, refd))
    flipped = drv.reference(heads=lambda c: [not h for h in c])
    assert not _agrees(check.train_gaps(drv.prog, flipped))


def test_coins_are_the_programs():
    """check.coins against the program's own schedule, generator and draw."""
    from types import SimpleNamespace

    from multimodal_outage_tpu_torch.core.config import DCRNNConfig, ModelConfig
    from multimodal_outage_tpu_torch.models.dcrnn import DCRNN
    from multimodal_outage_tpu_torch.train.steps import sampling_generator, tf_schedule

    for p0, tau in ((0.5, 20), (0.9, 0), (1.0, 0), (1.0, 2000)):
        cfg = ModelConfig(st_gnn="dcrnn", dcrnn=DCRNNConfig(teacher_forcing=p0, tf_decay_steps=tau))
        dec = DCRNN(4, 4, horizon=7, rnn_units=2, teacher_forcing=p0)
        for seed in (7, SEED % 2**31):
            for step in (0, 1, 2, 30, 99):
                p = float(tf_schedule(SimpleNamespace(cfg=cfg), step))
                assert check.coins(seed, step, p0, tau, 7) == dec.coins(p, sampling_generator(seed, step))


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


@pytest.mark.parametrize("name", TRAINING)
def test_control_and_half_batch_fail_the_train_limits(name):
    cell = _bf16_cell(name)
    drv = DRIVERS["train"](cell, SEED, "cpu")
    drv.setup()
    refd, yard = drv.reference(), drv.reference(ref.bf16)
    untaught = (drv.reference(heads=lambda c: [False] * len(c))
                if ref.teacher(cell.config["model"]) else None)
    assert check.verdict(check.train_gaps(drv.prog, refd, yard, untaught), cell.limits)[0]
    for bad in (drv.reference(ref.fp8), drv.reference(use_rows=drv.b // 2)):
        assert not check.verdict(check.train_gaps(bad, refd, yard, untaught), cell.limits)[0]


def test_the_teacher_ignored_fails_the_train_limits():
    """The program with every coin tails, against the reference, on
    dcrnn.train_b16_tf's committed limits: not correct."""
    cell = _bf16_cell("dcrnn.train_b16_tf")
    drv = DRIVERS["train"](cell, SEED, "cpu")
    drv.setup()
    refd, yard = drv.reference(), drv.reference(ref.bf16)
    untaught = drv.reference(heads=lambda c: [False] * len(c))
    assert check.verdict(check.train_gaps(drv.prog, refd, yard, untaught), cell.limits)[0]
    with drv.program.teacher_ignored():
        bad = DRIVERS["train"](cell, SEED, "cpu")
        bad.setup()
    gaps = check.train_gaps(bad.prog, refd, yard, untaught)
    assert gaps["teacher_gap_ratio"] > cell.limits["teacher_gap_ratio"], gaps


def test_the_yardstick_is_run_only_where_a_limit_reads_it(monkeypatch):
    """gwnet.train_b16's check is the reference's steps alone, as before;
    dcrnn.train_b16_tf's adds the bf16 yardstick's and the untaught
    reference's (every coin tails)."""
    for name, runs in (("gwnet.train_b16", ["ref"]),
                       ("dcrnn.train_b16_tf", ["ref", "bf16", "untaught"])):
        drv = DRIVERS["train"](tiny_cell(name), SEED, "cpu")
        drv.setup()
        done = {"ref": drv.reference(), "bf16": drv.reference(ref.bf16),
                "untaught": drv.reference(heads=lambda c: [False] * len(c))}
        seen = []

        def reference(quant=ref.ident, heads=None):
            seen.append("untaught" if heads else "bf16" if quant is ref.bf16 else "ref")
            return done[seen[-1]]

        monkeypatch.setattr(drv, "reference", reference)
        readings = drv.check()
        assert seen == runs and set(drv.cell.limits) <= set(readings)
        assert check.verdict(readings, drv.cell.limits)[0]


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


@pytest.mark.parametrize("name", TRAINING)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(name, monkeypatch):
    from multimodal_outage_tpu_torch.train import state

    monkeypatch.setattr(state.Adam, "step", lambda self, lr: None)
    assert run_cell(tiny_cell(name), SEED, 0.3, False, device="cpu")["correct"] is False


def test_a_step_that_ignores_the_teacher_is_not_correct(monkeypatch):
    """The program's decoder fed its own output at every step (every coin
    tails) under dcrnn.train_b16_tf's scheduled sampling."""
    from multimodal_outage_tpu_torch.models import dcrnn

    monkeypatch.setattr(dcrnn.DCRNN, "coins", lambda self, p, g: [False] * self.horizon)
    assert run_cell(tiny_cell("dcrnn.train_b16_tf"), SEED, 0.3, False, device="cpu")["correct"] is False


@pytest.mark.parametrize("name", TRAINING)
def test_a_step_over_half_the_batch_is_not_correct(name, monkeypatch):
    from multimodal_outage_tpu_torch.train import steps

    def half(model, batch, supports, gen, teacher, debug_nans, step):
        """The forward over the batch, the loss's mean over its first half."""
        yhat = model(batch["x"], batch["date_feats"], supports, train=True, generator=gen,
                     **teacher)
        b = yhat.shape[0] // 2
        torch.mean(torch.square(yhat[:b] - batch["y"][:b])).backward()
        return yhat.detach()

    monkeypatch.setattr(steps, "_forward_backward", half)
    assert run_cell(tiny_cell(name), SEED, 0.3, False, device="cpu")["correct"] is False


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
