"""The bf16 DCRNN kernel's cluster plan (ops/dcrnn_stack.py stack_plan,
cluster_layout, plan_ints) on the CPU: how many CTAs serve a sample, and
each CTA's shared-memory layout, at the shapes the card tests and the
benchmark run. A plain function of the shapes, the batch and the card's
co-scheduling counts, so no card is needed."""

import pytest
import torch

from multimodal_outage_tpu_torch.core.config import DCRNNConfig, ModelConfig
from multimodal_outage_tpu_torch.ops import dcrnn_stack as dsm

# clusters of C CTAs an H100 80GB HBM3 runs at once with each C's layout
# at full width (cudaOccupancyMaxActiveClusters: one CTA to an SM, a
# cluster inside one GPC)
H100 = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


def _shapes(full=True, units=8, dout=12, n=6, layers=2, k=2):
    """(n, layers, S, order, Dx0, Dout, U) of tests/test_torch_port_cuda.py
    _dcrnn_case: the default DCRNN on the 67-county graph, or its small
    configurations."""
    if full:
        cfg, n = ModelConfig(st_gnn="dcrnn"), 67
    else:
        cfg = ModelConfig(st_gnn="dcrnn", feature_vector_size=dout, time_embed_size=4,
                          dcrnn=DCRNNConfig(rnn_units=units, num_rnn_layers=layers,
                                            max_diffusion_step=k))
    d = cfg.dcrnn
    return (n, d.num_rnn_layers, 2, d.max_diffusion_step, cfg.st_gnn_in_dim,
            cfg.feature_vector_size, d.rnn_units)


SHAPES = {
    "full": _shapes(),
    "l3_k1": _shapes(False, layers=3, k=1),
    "l2_k3": _shapes(False, k=3),
    "padded": _shapes(False, units=12, dout=20, n=19),
}


def test_full_width_splits_a_sample_wide_and_a_batch_in_one_wave():
    """B=1 takes a cluster of 16 (one wave of one cluster); B=16 the
    largest C whose clusters all run at once on the H100 (4: 16 of 30),
    which the card measured fastest at B=16 (1.37 ms against 1.88 for 8
    and 2.45 for 16, PERF.md §6)."""
    assert dsm.stack_plan(1, *SHAPES["full"], H100)["C"] == 16
    assert dsm.stack_plan(16, *SHAPES["full"], H100)["C"] == 4
    assert dsm.stack_plan(17, *SHAPES["full"], H100)["C"] == 4


@pytest.mark.parametrize("b", [1, 16, 17])
@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_fits_a_block_and_splits_whole_unit_quads(name, b):
    shapes = SHAPES[name]
    lay = dsm.stack_plan(b, *shapes, H100)
    n, layers, _, _, _, _, units = shapes
    assert lay["total"] <= dsm.SMEM_LIMIT == 232_448
    assert (units // 4) % lay["C"] == 0 and lay["quads"] * lay["C"] == units // 4
    regions = [lay[k] for k in ("at", "states", "rh", "terms", "acc", "slots", "bias",
                                "weights")]
    assert regions == sorted(regions) and all(o % 16 == 0 for o in regions)
    slices = sorted(o for cell in lay["resident"] for o in cell if o >= 0)
    assert all(lay["weights"] <= o < lay["total"] and o % 16 == 0 for o in slices)
    assert len(set(slices)) == len(slices)
    assert lay["resident"][0][0] == -1  # the prepass reads encoder layer 0's x part
    ints = dsm.plan_ints(lay)
    assert len(ints) == 13 + 3 * 2 * layers and ints[0] == lay["C"] and ints[12] == lay["total"]


def test_full_width_keeps_every_slice_but_the_prepass_resident_at_c16():
    """At C=16 all projection weights but encoder layer 0's x part (the
    prepass's, read once) stay in shared memory: 76,800 bytes a CTA, 1/16
    of the 1,228,800 bytes of the other parts."""
    lay = dsm.cluster_layout(*SHAPES["full"], 16)
    res = [o for cell in lay["resident"] for o in cell]
    assert res.count(-1) == 1
    assert lay["total"] - lay["weights"] == 76_800


def test_plan_skips_splits_the_card_cannot_run_and_raises_when_none_fits():
    assert dsm.stack_plan(1, *SHAPES["full"], {**H100, 16: 0})["C"] == 8
    assert dsm.stack_plan(1, *SHAPES["full"], {1: 132})["C"] == 1
    with pytest.raises(ValueError, match="shared memory"):
        dsm.stack_plan(1, 300, 2, 2, 2, 320, 256, 64, H100)
    with pytest.raises(ValueError, match="shared memory"):
        dsm.stack_plan(1, *SHAPES["full"], {})


def test_plan_is_a_pure_function_of_its_inputs(monkeypatch):
    """No card is asked: the plan is the same with CUDA and the kernel
    library out of reach, and from one call to the next."""
    def no_card(*a, **k):
        raise AssertionError("the plan asked the card")

    monkeypatch.setattr(dsm, "_lib", no_card)
    monkeypatch.setattr(torch.cuda, "is_available", no_card)
    first = dsm.stack_plan(16, *SHAPES["full"], H100)
    assert dsm.stack_plan(16, *SHAPES["full"], dict(H100)) == first
    assert dsm.stack_plan(16, *SHAPES["full"], {**H100, 8: 16})["C"] == 8
