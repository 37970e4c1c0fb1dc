"""Kernel 1's up form (ops/double_conv.py fused_up_double_conv) on the CPU:
its shared-memory plan at the U-Net's four up levels, the wrapper's plain
version against the four ops it replaces, and the serving engine's
per-level route. The kernel against those ops on the card:
tests/test_torch_port_cuda.py -k up_form."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_outage_tpu_torch import serving, weights
from multimodal_outage_tpu_torch.core.config import ModelConfig
from multimodal_outage_tpu_torch.data.adjacency import model_supports
from multimodal_outage_tpu_torch.ops import double_conv as dcm
from multimodal_outage_tpu_torch.serving import ServingModel


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (H, Cl, C) of the four up levels at the *_fl67 widths: the skip has C
# channels at H², the low-resolution map Cl = 2C at (H/2)², the DoubleConv
# maps 2C → C
UP_LEVELS = [(16, 64, 32), (32, 32, 16), (64, 16, 8), (128, 8, 4)]
H100_SMEM = 232_448  # dynamic shared memory one block may have


@pytest.mark.parametrize("m", [469, 7504])
@pytest.mark.parametrize("h,cl,c", UP_LEVELS)
def test_up_plan_fits_the_four_levels(m, h, cl, c):
    """The up form's plan at B=1 and B=16 (M = 67·7·B frames): it fits a
    block, its tiles are even (each starts on a 2 × 2 block of the
    low-resolution map) and it holds the plain form's regions and the
    ConvTranspose's besides."""
    p = dcm.plan_bf16(m, h, h, 2 * c, c, cl)
    assert p.cl == cl and p.smem <= H100_SMEM and p.smem % 16 == 0
    assert p.th % 2 == 0 and p.tw % 2 == 0 and p.th <= h and p.tw <= h
    assert p.items == m * -(-h // p.th) * -(-h // p.tw)
    plain = dcm._bf16_smem(2 * c, c, p.th, p.tw)
    low_tile = (p.th // 2 + 2) * (p.tw // 2 + 2) * dcm._pix_stride(dcm._k_pad(cl)) * 2
    assert p.smem >= plain + 2 * low_tile
    skip, low, wt, w1 = _level(m, h, h, cl, c)
    assert dcm.up_form_takes(skip, low, wt, w1)


def _level(m, h, w, cl, c, cs=None, dtype=torch.bfloat16, low_hw=None):
    """The shapes of an up level's skip, low-resolution map, ConvTranspose
    weight and conv1 weight, as meta tensors (nothing allocated)."""
    cs = c if cs is None else cs
    lh, lw = low_hw or (h // 2, w // 2)
    meta = lambda *s: torch.empty(*s, dtype=dtype, device="meta")
    return meta(m, h, w, cs), meta(m, lh, lw, cl), meta(cl, c, 2, 2), meta(3, 3, cs + c, c)


@pytest.mark.parametrize("h,w,cin,c,cl", [
    (15, 16, 64, 32, 64),  # odd H: no tile starts on a 2 × 2 block everywhere
    (16, 16, 6, 4, 8),  # a skip of 2 channels: no cp.async
    (16, 16, 8, 4, 6),  # a low-resolution map of 6 channels
    (16, 16, 4, 4, 8),  # no skip
    (16, 16, 64, 6, 64),  # C not a multiple of 4
])
def test_up_plan_refuses_what_the_kernel_cannot_take(h, w, cin, c, cl):
    with pytest.raises(ValueError):
        dcm.plan_bf16(1, h, w, cin, c, cl)


@pytest.mark.parametrize("why,kw", [
    ("float32", dict(m=1, h=16, w=16, cl=16, c=8, dtype=torch.float32)),
    ("odd skip, padded", dict(m=1, h=15, w=16, cl=16, c=8, low_hw=(7, 8))),
    ("skip not twice the map", dict(m=1, h=16, w=16, cl=16, c=8, low_hw=(7, 8))),
    ("a skip of 2 channels", dict(m=1, h=16, w=16, cl=8, c=4, cs=2)),
    ("C = 2 (base_channels=2)", dict(m=1, h=128, w=128, cl=4, c=2)),
])
def test_up_form_refuses_what_it_cannot_take(why, kw):
    """The route's one test sends these levels to the four ops: float32,
    a skip that is not exactly twice the low-resolution map (the pad case),
    widths the plan refuses."""
    assert not dcm.up_form_takes(*_level(**kw)), why


@pytest.mark.parametrize("h,cl,c", UP_LEVELS)
def test_up_bound_counts_skip_low_and_out(h, cl, c):
    """The up form's byte bound is the plain form's over the concat less
    the upsampled half it no longer reads, plus the low-resolution map and
    the ConvTranspose's weight and bias; its operations add the
    ConvTranspose's Cl·C a pixel. At 128² and B=16: 2,458,911,912 bytes."""
    m = 7504
    less = 2 * m * h * h * c
    more = 2 * (m * (h // 2) ** 2 * cl + 4 * cl * c + c)
    plain = dcm.min_bytes(m, h, h, 2 * c, c, 2)
    assert dcm.up_min_bytes(m, h, h, c, cl, c, 2) == plain - less + more
    assert dcm.up_flops(m, h, h, c, cl, c) == dcm.flops(m, h, h, 2 * c, c) + 2 * m * h * h * cl * c
    if h == 128:
        assert dcm.up_min_bytes(m, h, h, c, cl, c, 2) == 2_458_911_912


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,cl,c", UP_LEVELS)
def test_up_wrapper_on_cpu_is_the_four_ops(dtype, h, cl, c):
    """On CPU tensors fused_up_double_conv runs ConvTranspose → concat →
    DoubleConv as the engine's four-op path does, bit for bit, and
    launches nothing."""
    rng = np.random.default_rng(h + cl)
    t = lambda *s, dt=dtype, k=1.0: torch.from_numpy(
        (rng.standard_normal(s) * k).astype(np.float32)).to(dt)
    m, hh = 2, min(h, 32)
    skip, low = t(m, hh, hh, c), t(m, hh // 2, hh // 2, cl)
    wt, bt = t(cl, c, 2, 2, k=cl ** -0.5), t(c, k=3.0)
    conv = (t(3, 3, 2 * c, c, k=(9 * c) ** -0.5), t(c, dt=torch.float32).abs(),
            t(c, dt=torch.float32), t(3, 3, c, c, k=(9 * c) ** -0.5),
            t(c, dt=torch.float32).abs(), t(c, dt=torch.float32))
    before = (dcm.fused_double_conv.launches, dcm.fused_double_conv.up_launches)
    got = dcm.fused_up_double_conv(skip, low, wt, bt, *conv)
    assert (dcm.fused_double_conv.launches, dcm.fused_double_conv.up_launches) == before
    y = F.conv_transpose2d(low.permute(0, 3, 1, 2), wt, bt, stride=2).permute(0, 2, 3, 1)
    want = dcm.fused_double_conv(torch.cat([skip, y], -1).contiguous(), *conv)
    assert got.dtype == dtype and float(want.float().abs().max()) > 0
    assert torch.equal(got, want)


def _engine(st_gnn, base=4, n=4, t=7, h=32, **kw):
    cfg = ModelConfig(st_gnn=st_gnn, base_channels=base, **kw)
    var = weights.init_variables(cfg, t, n, seed=0, image_size=h)
    return cfg, var, torch.from_numpy(model_supports(cfg, n))


def _request(n=4, t=7, h=32):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, n, t, h, h, 1)).astype(np.float32))
    return x, torch.tensor([0, 0, 0, 2022, 9, 26], dtype=torch.float32).repeat(1, t, 1)


@pytest.mark.parametrize("st_gnn,base,want", [
    ("gwnet", 4, (True,) * 4), ("dcrnn", 4, (True,) * 4), ("gman", 4, (True,) * 4),
    ("gwnet", 2, (True, True, True, False)),  # the last level's C = 2: kernel 1 does not take it
])
def test_bf16_engine_routes_each_up_level(st_gnn, base, want):
    """A bf16 engine's forward sends each up level whose widths the up form
    takes to it (all four at the three configs' widths) and says so in
    up_levels; a float32 engine and reference=True send none. Kernel 1
    stays the DoubleConv function of every level it runs."""
    cfg, var, sup = _engine(st_gnn, base)
    x, feats = _request()
    serve = ServingModel(cfg, var, sup, horizon=7, device="cpu")
    assert serve.up_levels == ()
    serve(x, feats)
    assert serve.up_levels == want
    assert [fn is dcm.fused_double_conv for fn in serve.double_conv_fns][5:] == list(want)
    ref = ServingModel(cfg, var, sup, horizon=7, device="cpu", reference=True)
    ref(x, feats)
    assert ref.up_levels == (False,) * 4
    f32 = ServingModel(dataclasses.replace(cfg, compute_dtype="float32"), var, sup, horizon=7,
                       device="cpu")
    f32(x, feats)
    assert f32.up_levels == (False,) * 4


@pytest.mark.parametrize("st_gnn", ["gwnet", "dcrnn", "gman"])
def test_reference_engine_keeps_the_four_ops(st_gnn, monkeypatch):
    """reference=True serves through ConvTranspose → pad → concat → the
    plain DoubleConv; the bf16 engine routes its four up levels to
    fused_up_double_conv, whose CPU version gives the same output bit for
    bit."""
    cfg, var, sup = _engine(st_gnn)
    x, feats = _request()
    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return dcm.fused_up_double_conv(*args)

    monkeypatch.setattr(serving, "fused_up_double_conv", counted)
    want = ServingModel(cfg, var, sup, horizon=7, device="cpu", reference=True)(x, feats)
    assert calls == []
    got = ServingModel(cfg, var, sup, horizon=7, device="cpu")(x, feats)
    assert [s[1] for s in calls] == [4, 8, 16, 32]
    assert torch.isfinite(want).all() and torch.equal(got, want)
