"""The port's kernels on the card, each held against its plain version.

Imports nothing of JAX, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tests marked `cuda` skip where torch.cuda.is_available() is False.
Tolerances: float32 within 1e-4 (summation order only). In bfloat16 a
different summation order can move a value across a rounding boundary and
the flip propagates, so the kernel is held to the plain version's own
accuracy against the same computation in float32 (chip_smoke.py states
the same bar)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_outage_tpu_torch import serving, weights
from multimodal_outage_tpu_torch.core.config import DCRNNConfig, GWNetConfig, ModelConfig
from multimodal_outage_tpu_torch.data.adjacency import model_supports, n_static_supports
from multimodal_outage_tpu_torch.ops import dcrnn_stack as dsm
from multimodal_outage_tpu_torch.ops import double_conv as dcm
from multimodal_outage_tpu_torch.ops import gwnet_layer as glm
from multimodal_outage_tpu_torch.ops import gwnet_stack as gsm
from multimodal_outage_tpu_torch.ops import max_pool as mp
from multimodal_outage_tpu_torch.serving import ServingModel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (README: the port's tests on the H100)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_kernel_matches(got, want, truth):
    got, want, truth = got.float(), want.float(), truth.float()
    assert torch.isfinite(got).all()
    if torch.equal(want, truth):  # float32: the plain version is the truth
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        return
    e_got, e_want = (got - truth).abs(), (want - truth).abs()
    assert e_got.max() <= 2.0 * e_want.max() + 1e-6
    assert e_got.square().mean().sqrt() <= 1.25 * e_want.square().mean().sqrt() + 1e-6


def _double_conv_args(m, h, w, cin, c, dtype, device, seed=1):
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(a.astype(np.float32)).to(device, dt)
    return (
        t(rng.standard_normal((m, h, w, cin)), dtype),
        t(rng.standard_normal((3, 3, cin, c)) * (2 / (9 * cin)) ** 0.5, dtype),
        t(rng.uniform(0.5, 1.5, c)), t(rng.standard_normal(c) * 0.1),
        t(rng.standard_normal((3, 3, c, c)) * (2 / (9 * c)) ** 0.5, dtype),
        t(rng.uniform(0.5, 1.5, c)), t(rng.standard_normal(c) * 0.1),
    )


# the 9 (H, Cin, C) of a serving forward, plus ragged tiles (12×20, and
# 20×12 with many channels)
SHAPES = [
    (128, 128, 1, 4), (64, 64, 4, 8), (32, 32, 8, 16), (16, 16, 16, 32), (8, 8, 32, 64),
    (16, 16, 64, 32), (32, 32, 32, 16), (64, 64, 16, 8), (128, 128, 8, 4), (12, 20, 8, 4),
    (20, 12, 64, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,cin,c", SHAPES)
def test_double_conv_kernel_matches_plain(cuda, dtype, h, w, cin, c):
    args = _double_conv_args(3, h, w, cin, c, dtype, cuda)
    before = dcm.fused_double_conv.launches
    got = dcm.fused_double_conv(*args)
    torch.cuda.synchronize()
    assert dcm.fused_double_conv.launches == before + 1
    want = dcm.double_conv_reference(*args)
    truth = dcm.double_conv_reference(*(a.float() for a in args))
    _assert_kernel_matches(got, want, truth)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,h,w,cin,c",
    [(1, 128, 128, 1, 4), (1, 16, 16, 64, 32),  # one image
     (2 * 132 + 1, 8, 8, 32, 64), (2 * 132 + 1, 64, 64, 4, 8),  # the persistent loop's remainder
     (2 * 132 + 1, 32, 32, 1, 4), (3, 30, 18, 30, 16),  # register-staged input (Cin % 4 != 0)
     (469, 8, 8, 32, 64), (469, 16, 16, 64, 32),  # a B=1 request's deepest shapes
     (3, 20, 12, 64, 32), (2, 9, 13, 12, 20), (2, 11, 6, 3, 12), (1, 8, 8, 4, 68)],
)
def test_double_conv_bf16_kernel_batches_and_padding(cuda, m, h, w, cin, c):
    """The tensor-core body at other batch sizes (the persistent grid and
    its last partial wave) and at channel counts it pads (Cin = 1, 3, 12,
    30; C = 12, 20, 68), held to the bf16 bar."""
    args = _double_conv_args(m, h, w, cin, c, torch.bfloat16, cuda, seed=m)
    before = dcm.fused_double_conv.launches
    got = dcm.fused_double_conv(*args)
    torch.cuda.synchronize()
    assert dcm.fused_double_conv.launches == before + 1
    want = dcm.double_conv_reference(*args)
    truth = dcm.double_conv_reference(*(a.float() for a in args))
    _assert_kernel_matches(got, want, truth)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_double_conv_gradients_through_the_kernel(cuda, dtype):
    """fused_double_conv on the card: the forward launches the kernel, the
    gradients of every input equal autograd of the plain version."""
    args = _double_conv_args(3, 16, 16, 8, 16, dtype, cuda, seed=4)
    dy = torch.randn(3, 16, 16, 16, generator=torch.Generator(device="cuda").manual_seed(5),
                     device=cuda).to(dtype)
    grads = []
    for fn in (dcm.fused_double_conv, dcm.double_conv_reference):
        leaves = [a.clone().requires_grad_() for a in args]
        before = dcm.fused_double_conv.launches
        y = fn(*leaves)
        assert y.requires_grad
        torch.autograd.backward(y, dy)
        grads.append([v.grad for v in leaves])
        assert dcm.fused_double_conv.launches == before + (fn is dcm.fused_double_conv)
    # the same plain backward from the same inputs; cuDNN's weight
    # gradient may sum in another order from call to call, and in bf16 that
    # can move a stored gradient by one ulp (2^-8 relative)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol * float(want.abs().max()))
    assert all(float(g.abs().max()) > 0 for g in grads[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_engine_takes_the_kernel_at_every_level(cuda, dtype):
    """The default U-Net (base_channels=4): all 9 DoubleConv levels go to
    the kernel; base_channels=2 sends the two C = 2 levels to the plain
    version and still serves."""
    n, t, h = 2, 2, 32
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, n, t, h, h, 1)).astype(np.float32)).to(cuda)
    feats = torch.tensor([0, 0, 0, 2022, 9, 26], dtype=torch.float32).repeat(1, t, 1).to(cuda)
    for base, want in ((4, [True] * 9), (2, [False] + [True] * 7 + [False])):
        cfg = ModelConfig(compute_dtype=dtype, base_channels=base)
        var = weights.init_variables(cfg, t, n, seed=0, image_size=h)
        serve = ServingModel(cfg, var, torch.eye(n)[None], horizon=t, device="cuda")
        assert [fn is dcm.fused_double_conv for fn in serve.double_conv_fns] == want
        before = dcm.fused_double_conv.launches
        y = serve(x, feats)
        torch.cuda.synchronize()
        assert dcm.fused_double_conv.launches - before == sum(want)
        assert torch.isfinite(y).all()


def _stack_inputs(cfg, n, b, t, dtype, device):
    var = weights.init_variables(cfg, t, n, seed=2, image_size=16)
    st, bs = var["params"]["st_gnn"], var["batch_stats"]["st_gnn"]
    rng = np.random.default_rng(3)
    for v in bs.values():  # non-trivial running stats: BN folding exercised
        v["mean"] = torch.from_numpy(rng.normal(0, 0.1, v["mean"].shape).astype(np.float32))
        v["var"] = torch.from_numpy(rng.uniform(0.5, 1.5, v["var"].shape).astype(np.float32))
    g = cfg.gwnet
    sp = {k: v.to(device) for k, v in gsm.stack_params_from_module(
        st, bs, g.blocks * g.layers, dtype).items()}
    if dtype == torch.bfloat16:  # the kernel's tensor-core body reads these
        sp["frags"] = gsm.stack_fragments(sp)
    sup = gsm.adaptive_supports(
        torch.stack([torch.eye(n)] * n_static_supports(g.adjtype)),
        st.get("nodevec1"), st.get("nodevec2"), dtype,
    ).to(device)
    x = torch.from_numpy(
        rng.standard_normal((b, n, t, cfg.st_gnn_in_dim)).astype(np.float32)
    ).to(device, dtype)
    return x, sup, sp


SMALL = GWNetConfig(
    residual_channels=8, dilation_channels=8, skip_channels=16, end_channels=32,
    blocks=2, layers=2, node_embed_dim=4,
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "gw,n,b",
    [(SMALL, 7, 2), (GWNetConfig(), 67, 1), (GWNetConfig(), 67, 16),
     (GWNetConfig(addaptadj=False), 20, 2),  # one support
     (GWNetConfig(adjtype="doubletransition", order=3), 9, 2),  # 3 supports, order 3
     # the full-width shapes of --adjtype doubletransition (S = 3: its bf16
     # body reads the weights from L2, they do not fit beside the buffers)
     # and --adjtype transition --no_addaptadj (S = 1)
     (GWNetConfig(adjtype="doubletransition"), 67, 1),
     (GWNetConfig(adjtype="doubletransition"), 67, 16),
     (GWNetConfig(adjtype="transition", addaptadj=False), 67, 16)],
)
def test_stack_kernel_matches_plain(cuda, dtype, gw, n, b):
    cfg = ModelConfig(gwnet=gw)
    x, sup, sp = _stack_inputs(cfg, n, b, 7, dtype, cuda)
    before = gsm.gwnet_stack_forward.launches
    got = gsm.gwnet_stack_forward(x, sup, sp, order=gw.order)
    torch.cuda.synchronize()
    assert gsm.gwnet_stack_forward.launches == before + 1
    want = gsm.stack_forward_reference(x, sup, sp, order=gw.order)
    truth = gsm.stack_forward_reference(x.float(), sup.float(), _f32(sp), order=gw.order)
    _assert_kernel_matches(got, want, truth)


def _f32(sp):
    """The stack's weights in float32, without the bf16 fragments."""
    return {k: v.float() for k, v in sp.items() if k != "frags"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_kernel_padded_widths(cuda, dtype):
    """Widths that pad every tile of the tensor-core body through all 8
    layers: N=19 node rows (2 m-tiles), C=Cd=12 (K to 16, the filter and
    gate blocks to 16), Cs=20, Ce=36 and Cout=20 (K to 32 / 48, N to 24 /
    40), Cin=24, at B=2."""
    gw = GWNetConfig(residual_channels=12, dilation_channels=12, skip_channels=20,
                     end_channels=36, node_embed_dim=4)
    cfg = ModelConfig(gwnet=gw, feature_vector_size=20, time_embed_size=4)
    x, sup, sp = _stack_inputs(cfg, 19, 2, 3, dtype, cuda)
    before = gsm.gwnet_stack_forward.launches
    got = gsm.gwnet_stack_forward(x, sup, sp, order=gw.order)
    torch.cuda.synchronize()
    assert gsm.gwnet_stack_forward.launches == before + 1
    want = gsm.stack_forward_reference(x, sup, sp, order=gw.order)
    truth = gsm.stack_forward_reference(x.float(), sup.float(), _f32(sp), order=gw.order)
    _assert_kernel_matches(got, want, want if dtype == torch.float32 else truth)


@pytest.mark.cuda
def test_stack_wrapper_needs_fragments_in_bf16(cuda):
    """bf16 without sp["frags"], or with a fragment of the wrong shape,
    raises before any launch; float32 needs none."""
    x, sup, sp = _stack_inputs(ModelConfig(gwnet=SMALL), 7, 1, 2, torch.bfloat16, cuda)
    before = gsm.gwnet_stack_forward.launches
    with pytest.raises(ValueError, match="frags"):
        gsm.gwnet_stack_forward(x, sup, {k: v for k, v in sp.items() if k != "frags"})
    short = dict(sp, frags=dict(sp["frags"], wc=sp["frags"]["wc"][:, :-1].contiguous()))
    with pytest.raises(ValueError, match="frags.wc"):
        gsm.gwnet_stack_forward(x, sup, short)
    assert gsm.gwnet_stack_forward.launches == before
    x32, sup32, sp32 = _stack_inputs(ModelConfig(gwnet=SMALL), 7, 1, 2, torch.float32, cuda)
    gsm.gwnet_stack_forward(x32, sup32, sp32)
    torch.cuda.synchronize()
    assert gsm.gwnet_stack_forward.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_kernels_match_plain_engine(cuda, dtype):
    cfg = ModelConfig(compute_dtype=dtype)
    n, t, h = 4, 3, 32
    var = weights.init_variables(cfg, t, n, seed=0, image_size=h)
    sup = torch.eye(n)[None]
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, n, t, h, h, 1)).astype(np.float32)).to(cuda)
    feats = torch.tensor([0, 0, 0, 2022, 9, 26], dtype=torch.float32).repeat(2, t, 1).to(cuda)
    fast = ServingModel(cfg, var, sup, horizon=t, device="cuda")
    before = (dcm.fused_double_conv.launches, gsm.gwnet_stack_forward.launches)
    got = fast(x, feats)
    torch.cuda.synchronize()
    assert (dcm.fused_double_conv.launches - before[0],
            gsm.gwnet_stack_forward.launches - before[1]) == (9, 1)
    want = ServingModel(cfg, var, sup, horizon=t, device="cuda", reference=True)(x, feats)
    f32 = ModelConfig(compute_dtype="float32")
    truth = ServingModel(f32, var, sup, horizon=t, device="cuda", reference=True)(x, feats)
    _assert_kernel_matches(got, want, want if dtype == "float32" else truth)


def _up_form_args(m, h, w, cl, c, device, seed):
    """skip, low, the ConvTranspose's weight and bias, and the DoubleConv's
    operands of an up level (DoubleConv 2C → C), bf16, made on the device
    from a seed. The ConvTranspose bias is large (~4), so a bias written
    into the concat's SAME padding moves every border pixel."""
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s, k=1.0, dt=torch.bfloat16: (
        torch.randn(*s, generator=g, device=device) * k).to(dt)
    cin = 2 * c
    return (
        r(m, h, w, c), r(m, h // 2, w // 2, cl), r(cl, c, 2, 2, k=cl ** -0.5),
        r(c, k=0.5) + 4.0,
        r(3, 3, cin, c, k=(2 / (9 * cin)) ** 0.5),
        r(c, dt=torch.float32).abs() + 0.5, r(c, k=0.1, dt=torch.float32),
        r(3, 3, c, c, k=(2 / (9 * c)) ** 0.5),
        r(c, dt=torch.float32).abs() + 0.5, r(c, k=0.1, dt=torch.float32),
    )


def _four_ops(skip, low, wt, bt, *conv):
    """ConvTranspose → concat → kernel 1, as the engine runs an up level
    the up form does not take."""
    y = F.conv_transpose2d(low.permute(0, 3, 1, 2), wt, bt, stride=2).permute(0, 2, 3, 1)
    return dcm.fused_double_conv(torch.cat([skip, y], -1).contiguous(), *conv)


# (H, W, Cl, C): the four up levels at the *_fl67 widths, and each at a
# size its plan's tiles do not divide
UP_SHAPES = [(16, 16, 64, 32), (32, 32, 32, 16), (64, 64, 16, 8), (128, 128, 8, 4)]
UP_RAGGED = [(20, 12, 64, 32), (36, 20, 32, 16), (40, 52, 16, 8), (72, 40, 8, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,h,w,cl,c",
                         [(m, *s) for m in (469, 7504) for s in UP_SHAPES]
                         + [(5, *s) for s in UP_RAGGED])
def test_up_form_matches_the_four_ops(cuda, m, h, w, cl, c):
    """Kernel 1's up form against ConvTranspose → concat → kernel 1, both
    held to the float32 computation of the same level: the up form rounds
    its upsampled half to bf16 once, so it is held to the four ops' own
    error (the bf16 bar)."""
    args = _up_form_args(m, h, w, cl, c, cuda, seed=h + m)
    before = (dcm.fused_double_conv.launches, dcm.fused_double_conv.up_launches)
    got = dcm.fused_up_double_conv(*args)
    torch.cuda.synchronize()
    assert (dcm.fused_double_conv.launches - before[0],
            dcm.fused_double_conv.up_launches - before[1]) == (1, 1)
    want = _four_ops(*args)
    truth = dcm.up_double_conv_reference(*(a.float() for a in args))
    _assert_kernel_matches(got, want, truth)


@pytest.mark.cuda
@pytest.mark.parametrize("st_gnn", ["gwnet", "dcrnn", "gman"])
def test_engine_up_form_matches_the_four_ops(cuda, st_gnn, monkeypatch):
    """A B=1 forecast at each configuration's widths (67 counties, 7 days,
    128²): the engine takes the up form at all four up levels (9 kernel 1
    launches a forward, 4 of them up-form) and is held, against the float32
    plain engine, to the same engine with the route refused at every level,
    which runs each through the four ops."""
    cfg = ModelConfig(st_gnn=st_gnn)
    n, t, h = 67, 7, 128
    var = weights.init_variables(cfg, t, n, seed=0, image_size=h)
    sup = torch.from_numpy(model_supports(cfg, n))
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((1, n, t, h, h, 1)).astype(np.float32)).to(cuda)
    feats = torch.tensor([0, 0, 0, 2022, 9, 26], dtype=torch.float32).repeat(1, t, 1).to(cuda)
    engine = ServingModel(cfg, var, sup, horizon=t, device="cuda")
    grew, out, took = [], [], []
    for route in (serving.up_form_takes, lambda *a: False):
        monkeypatch.setattr(serving, "up_form_takes", route)
        before = (dcm.fused_double_conv.launches, dcm.fused_double_conv.up_launches)
        out.append(engine(x, feats))
        torch.cuda.synchronize()
        grew.append((dcm.fused_double_conv.launches - before[0],
                     dcm.fused_double_conv.up_launches - before[1]))
        took.append(engine.up_levels)
    assert grew == [(9, 4), (9, 0)]
    assert took == [(True,) * 4, (False,) * 4]
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    truth = ServingModel(f32, var, sup, horizon=t, device="cuda", reference=True)(x, feats)
    _assert_kernel_matches(out[0], out[1], truth)


@pytest.mark.cuda
def test_up_form_rejects_bad_inputs(cuda):
    """The up form raises, launching nothing, on what it does not take: an
    odd size, a low-resolution map not half the skip, float32, a
    misaligned skip, a gradient asked for."""
    args = _up_form_args(2, 16, 16, 16, 8, cuda, seed=0)
    skip, low = args[:2]
    bad = [
        (_up_form_args(2, 15, 16, 16, 8, cuda, seed=0), ValueError),
        ((skip, low[:, :4], *args[2:]), ValueError),
        (tuple(a.float() for a in args), TypeError),
        ((torch.empty(skip.numel() + 1, dtype=skip.dtype, device=cuda)[1:].view(skip.shape),
          *args[1:]), ValueError),
        ((skip, low, args[2].clone().requires_grad_(), *args[3:]), ValueError),
    ]
    before = (dcm.fused_double_conv.launches, dcm.fused_double_conv.up_launches)
    for case, err in bad:
        with pytest.raises(err):
            dcm.fused_up_double_conv(*case)
    assert (dcm.fused_double_conv.launches, dcm.fused_double_conv.up_launches) == before


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    args = _double_conv_args(1, 8, 8, 4, 8, torch.float32, cuda)
    with pytest.raises(ValueError):  # weights in another dtype than x
        dcm.fused_double_conv(args[0], args[1].to(torch.bfloat16), *args[2:])
    with pytest.raises(TypeError):  # fp16 storage is not taken
        dcm.fused_double_conv(args[0].half(), *args[1:])
    with pytest.raises(ValueError):  # non-contiguous x
        dcm.fused_double_conv(args[0].transpose(1, 2), *args[1:])
    # bf16 shapes the tensor-core body refuses raise; nothing falls back
    for cin, c in ((4, 6), (4, 136)):
        bad = _double_conv_args(1, 8, 8, cin, c, torch.bfloat16, cuda)
        before = dcm.fused_double_conv.launches
        with pytest.raises(ValueError):
            dcm.fused_double_conv(*bad)
        assert dcm.fused_double_conv.launches == before
    bf = _double_conv_args(1, 8, 8, 8, 8, torch.bfloat16, cuda)
    shifted = torch.empty(8 * 8 * 8 + 1, dtype=torch.bfloat16, device=cuda)[1:]
    with pytest.raises(ValueError):  # x not 16-byte aligned (cp.async)
        dcm.fused_double_conv(shifted.view(1, 8, 8, 8), *bf[1:])
    x, sup, sp = _stack_inputs(ModelConfig(gwnet=SMALL), 7, 1, 2, torch.float32, cuda)
    with pytest.raises(ValueError):
        gsm.gwnet_stack_forward(x, sup.to(torch.bfloat16), sp)


# (H, C) of the four U-Net pools at full width (W·C = 512 at each), plus
# narrow pixels that take the 8- and 4-byte accesses
POOL_SHAPES = [(128, 4), (64, 8), (32, 16), (16, 32), (12, 2), (6, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c", POOL_SHAPES)
def test_max_pool_kernels_match_plain(cuda, dtype, h, c):
    """Exact equality: both only copy values. ReLU'd inputs tie often."""
    m = 8 * 67 * 7 if h >= 16 else 5  # the images of a B=8 train step
    gen = torch.Generator(device="cuda").manual_seed(h + c)
    x = torch.relu(torch.randn(m, h, h, c, generator=gen, device=cuda)).to(dtype)
    g = torch.randn(m, h // 2, h // 2, c, generator=gen, device=cuda).to(dtype)
    before = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
    y = mp.max_pool_forward(x)
    dx = mp.max_pool_backward(x, g)
    torch.cuda.synchronize()
    assert (mp.max_pool_forward.launches - before[0], mp.max_pool_backward.launches - before[1]) == (1, 1)
    assert torch.equal(y, mp.max_pool_reference(x))
    assert torch.equal(dx, mp.max_pool_backward_reference(x, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool_kernel_tie_routing(cuda, dtype):
    """[[0,5],[5,0]] routes to (1,0) and an all-equal window to (0,0), as
    the JAX kernel routes them; autograd goes through both kernels."""
    x = torch.zeros(1, 2, 64, 2)
    x[0, :, 0:2, :] = torch.tensor([[0.0, 5.0], [5.0, 0.0]])[:, :, None]
    x[0, :, 2:4, :] = 7.0
    x = x.to(cuda, dtype).requires_grad_()
    mp.max_pool_2x2_pallas(x).backward(torch.full((1, 1, 32, 2), 3.0, device=cuda, dtype=dtype))
    dx = x.grad.float().cpu()
    assert dx[0, 1, 0, 0] == 3.0 and dx[0, 0, 1, 0] == 0.0 and dx[0, 0, 0, 0] == 0.0
    assert dx[0, 0, 2, 0] == 3.0 and dx[0, :, 2:4, 0].sum() == 3.0


@pytest.mark.cuda
def test_max_pool_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros(2, 8, 8, 4, device=cuda)
    with pytest.raises(TypeError):
        mp.max_pool_forward(x.half())
    with pytest.raises(ValueError):  # odd H
        mp.max_pool_forward(x[:, :7])
    with pytest.raises(ValueError):  # not contiguous
        mp.max_pool_forward(x.transpose(1, 2))
    with pytest.raises(ValueError):  # cotangent of the wrong shape
        mp.max_pool_backward(x, torch.zeros(2, 4, 4, 2, device=cuda))


def _layer_args(b, n, t, c, cd, cs, s_count, order, dtype, device, seed=0):
    """Inputs of one Graph WaveNet layer: x, row-softmax supports and the
    eight weights, made with numpy from `seed`."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((s_count, n, n))
    sup = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    nt = s_count * order + 1
    shapes = [(c, cd), (cd,), (c, cd), (cd,), (cd, cs), (cs,), (nt * cd, c), (c,)]
    params = [rng.standard_normal(s) * ((1 / s[0]) ** 0.5 if len(s) == 2 else 0.1) for s in shapes]
    t_ = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device, dtype)
    return [t_(rng.standard_normal((b, n, t, c))), t_(sup), *(t_(p) for p in params)]


# (B, N, T, C, Cd, Cs, S, order): the full-width layer at the batch sizes
# of serving and training, and at B=8 with 1 and 3 supports (--no_addaptadj,
# --adjtype doubletransition), small shapes with 1 and 3 supports, and one
# whose x and weight rows are not 16-byte multiples (C = 12, Cs = 36) and
# whose diffusion terms pad (Cd = 20 → 32 columns)
LAYER_SHAPES = [(1, 67, 7, 32, 32, 256, 2, 2), (8, 67, 7, 32, 32, 256, 2, 2),
                (16, 67, 7, 32, 32, 256, 2, 2), (8, 67, 7, 32, 32, 256, 1, 2),
                (8, 67, 7, 32, 32, 256, 3, 2), (2, 7, 3, 8, 8, 16, 1, 2),
                (2, 9, 3, 8, 12, 16, 3, 3), (3, 19, 5, 12, 20, 36, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LAYER_SHAPES)
def test_gwnet_layer_kernel_matches_plain(cuda, dtype, shape):
    *dims, order = shape
    args = _layer_args(*dims, order, dtype, cuda)
    before = glm.gwnet_layer_forward.launches
    h, s = glm.gwnet_layer_forward(*args, order=order)
    torch.cuda.synchronize()
    assert glm.gwnet_layer_forward.launches == before + 1
    hw, sw = glm.gwnet_layer_reference(*args, order=order)
    ht, st = glm.gwnet_layer_reference(*(a.float() for a in args), order=order)
    _assert_kernel_matches(h, hw, hw if dtype == torch.float32 else ht)
    _assert_kernel_matches(s, sw, sw if dtype == torch.float32 else st)


@pytest.mark.cuda
def test_gwnet_layer_gradients_through_the_kernel(cuda):
    """fused_gwnet_layer on the card: the forward launches the kernel, the
    gradients (supports included) equal autograd of the plain version."""
    args = _layer_args(8, 67, 7, 32, 32, 256, 2, 2, torch.float32, cuda, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    dh = torch.randn(8, 67, 7, 32, generator=gen, device=cuda)
    ds = torch.randn(8, 67, 7, 256, generator=gen, device=cuda)
    grads = []
    for fn in (glm.fused_gwnet_layer, glm.gwnet_layer_reference):
        leaves = [a.clone().requires_grad_() for a in args]
        before = glm.gwnet_layer_forward.launches
        torch.autograd.backward(fn(*leaves, order=2), (dh, ds))
        grads.append([v.grad for v in leaves])
        assert glm.gwnet_layer_forward.launches == before + (fn is glm.fused_gwnet_layer)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert grads[0][1].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LAYER_SHAPES)
def test_gwnet_layer_smem_bytes_match_layout(cuda, shape):
    """The library's shared memory per block: the bf16 body's layout is the
    Python mirror's (bf16_layout) field by field, every offset, stride and
    padded width, and its size is the mirror's total; the float32 body's
    size is its own sum."""
    _, n, _, c, cd, cs, s_count, order = shape
    dims = (n, c, cd, cs, s_count, order)
    mirror = glm.bf16_layout(*dims)
    assert sorted(mirror) == sorted(glm.LAYOUT_FIELDS)
    assert glm.smem_layout(*dims) == mirror
    assert glm.smem_bytes(*dims, torch.bfloat16) == mirror["total"]
    nt = s_count * order + 1
    assert glm.smem_bytes(*dims, torch.float32) == 4 * (n * nt * cd + n * 2 * cd + s_count * n * n)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [LAYER_SHAPES[1], LAYER_SHAPES[-1]])
def test_gwnet_layer_bf16_large_gate_biases(cuda, shape):
    """bf = bg = 3 + noise: a pad node row of g would be tanh(bf)·σ(bg) ≈
    0.95, far from zero; none may reach s or h."""
    *dims, order = shape
    args = _layer_args(*dims, order, torch.bfloat16, cuda, seed=3)
    args[3] = args[3] + 3.0
    args[5] = args[5] + 3.0
    h, s = glm.gwnet_layer_forward(*args, order=order)
    torch.cuda.synchronize()
    hw, sw = glm.gwnet_layer_reference(*args, order=order)
    ht, st = glm.gwnet_layer_reference(*(a.float() for a in args), order=order)
    _assert_kernel_matches(h, hw, ht)
    _assert_kernel_matches(s, sw, st)


@pytest.mark.cuda
def test_gwnet_layer_bf16_gradients_through_the_kernel(cuda):
    """fused_gwnet_layer in bf16 at full width: the forward is the kernel's
    (held to the plain version's accuracy), the gradients (supports
    included) are autograd of the plain bf16 version on the same inputs."""
    args = _layer_args(8, 67, 7, 32, 32, 256, 2, 2, torch.bfloat16, cuda, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    dh = torch.randn(8, 67, 7, 32, generator=gen, device=cuda).to(torch.bfloat16)
    ds = torch.randn(8, 67, 7, 256, generator=gen, device=cuda).to(torch.bfloat16)
    outs, grads = [], []
    for fn in (glm.fused_gwnet_layer, glm.gwnet_layer_reference):
        leaves = [a.clone().requires_grad_() for a in args]
        before = glm.gwnet_layer_forward.launches
        out = fn(*leaves, order=2)
        torch.autograd.backward(out, (dh, ds))
        assert glm.gwnet_layer_forward.launches == before + (fn is glm.fused_gwnet_layer)
        outs.append([o.detach() for o in out])
        grads.append([v.grad for v in leaves])
    truth = glm.gwnet_layer_reference(*(a.float() for a in args), order=2)
    for got, want, tr in zip(*outs, truth):
        _assert_kernel_matches(got, want, tr)
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want)
    assert grads[0][1].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gwnet_layer_launches_one_kernel_per_call(cuda, dtype):
    """One call is one CUDA kernel on the device (no packing or copy
    launches), the bf16 body in bf16 and the float32 body in float32."""
    args = _layer_args(8, 67, 7, 32, 32, 256, 2, 2, dtype, cuda)
    glm.gwnet_layer_forward(*args, order=2)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        glm.gwnet_layer_forward(*args, order=2)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1, names
    assert "gwnet_layer_kernel" in names[0]
    assert ("gwnet_layer_kernel_bf16" in names[0]) == (dtype == torch.bfloat16), names


def _dcrnn_case(full: bool, b: int, dtype, device, layers=2, k=2, units=8, dout=12, n=6):
    if full:  # the default DCRNN on the Florida graph (dual random walk, S=2)
        cfg, n, t = ModelConfig(st_gnn="dcrnn"), 67, 7
    else:
        cfg = ModelConfig(st_gnn="dcrnn", feature_vector_size=dout, time_embed_size=4,
                          dcrnn=DCRNNConfig(rnn_units=units, num_rnn_layers=layers,
                                            max_diffusion_step=k))
        t = 4
    d = cfg.dcrnn
    st = weights.init_variables(cfg, t, n, seed=2, image_size=128 if full else 16)["params"]["st_gnn"]
    sup = torch.from_numpy(model_supports(cfg, n)).to(device, dtype)
    arch = dict(num_rnn_layers=d.num_rnn_layers, max_diffusion_step=d.max_diffusion_step,
                rnn_units=d.rnn_units)
    sp = dsm.stack_params_to(dsm.dcrnn_stack_params(
        st, n_supports=sup.shape[0], input_dim=cfg.st_gnn_in_dim,
        output_dim=cfg.feature_vector_size, **arch), device, dtype)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, n, t, cfg.st_gnn_in_dim)).astype(np.float32)).to(device, dtype)
    return x, sup, sp, dict(horizon=t, **arch)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("full,b,layers,k", [(True, 1, 2, 2), (True, 3, 2, 2), (True, 16, 2, 2),
                                              (True, 17, 2, 2), (False, 2, 3, 1),
                                              (False, 2, 2, 3)])
def test_dcrnn_stack_kernel_matches_plain(cuda, dtype, full, b, layers, k):
    """Every split the plan picks (B = 16 and 17 at full width: a smaller
    cluster, a ragged last wave) against the plain version; one launch a
    call, its CTAs per sample counted (C >= 8 at B=1, full width, bf16;
    one block a sample in float32)."""
    x, sup, sp, kw = _dcrnn_case(full, b, dtype, cuda, layers, k)
    before = dsm.dcrnn_stack_forward.launches
    ctas = dict(dsm.dcrnn_stack_forward.ctas_per_sample)
    got = dsm.dcrnn_stack_forward(x, sup, sp, **kw)
    torch.cuda.synchronize()
    assert dsm.dcrnn_stack_forward.launches == before + 1
    grew = {c: v - ctas.get(c, 0) for c, v in dsm.dcrnn_stack_forward.ctas_per_sample.items()
            if v != ctas.get(c, 0)}
    assert list(grew.values()) == [1], grew
    if dtype == torch.float32:
        assert list(grew) == [1]
    elif full and b == 1:
        assert list(grew)[0] >= 8, grew
    want = dsm.stack_forward_reference(x, sup, sp, **kw)
    f32 = lambda v: v.float()
    sp32 = {"cells": [tuple(map(f32, c)) for c in sp["cells"]],
            "proj_w": f32(sp["proj_w"]), "proj_b": f32(sp["proj_b"])}
    truth = dsm.stack_forward_reference(x.float(), sup.float(), sp32, **kw)
    _assert_kernel_matches(got, want, want if dtype == torch.float32 else truth)


@pytest.mark.cuda
def test_dcrnn_stack_bf16_kernel_padded_widths(cuda):
    """bf16 at widths that pad every tile: N=19 node rows (2 m-tiles),
    U=12 (K to 16, the gates to 24 and the candidate to 16 columns),
    Dx0=24 and Dout=20 (K to 32, N to 24), at B=2."""
    x, sup, sp, kw = _dcrnn_case(False, 2, torch.bfloat16, cuda, units=12, dout=20, n=19)
    before = dsm.dcrnn_stack_forward.launches
    got = dsm.dcrnn_stack_forward(x, sup, sp, **kw)
    torch.cuda.synchronize()
    assert dsm.dcrnn_stack_forward.launches == before + 1
    want = dsm.stack_forward_reference(x, sup, sp, **kw)
    truth = dsm.stack_forward_reference(x.float(), sup.float(),
                                        dsm.stack_params_to(sp, cuda, torch.float32), **kw)
    _assert_kernel_matches(got, want, truth)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", ["dcrnn", "gwnet_pallas"])
def test_st_gnn_engines_match_plain_engine(cuda, dtype, engine):
    """The DCRNN engine (one dcrnn_stack launch per forward) and the
    per-layer Graph WaveNet engine (8 gwnet_layer launches) against the
    same engines on the plain versions."""
    st_gnn = "dcrnn" if engine == "dcrnn" else "gwnet"
    kw = {} if engine == "dcrnn" else dict(gwnet_stack=False, gwnet_pallas=True)
    cfg = ModelConfig(compute_dtype=dtype, st_gnn=st_gnn)
    n, t, h = 4, 3, 32
    var = weights.init_variables(cfg, t, n, seed=0, image_size=h)
    sup = torch.from_numpy(model_supports(cfg, n))
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, n, t, h, h, 1)).astype(np.float32)).to(cuda)
    feats = torch.tensor([0, 0, 0, 2022, 9, 26], dtype=torch.float32).repeat(2, t, 1).to(cuda)
    counters = (dcm.fused_double_conv, dsm.dcrnn_stack_forward, glm.gwnet_layer_forward,
                gsm.gwnet_stack_forward)
    before = [c.launches for c in counters]
    got = ServingModel(cfg, var, sup, horizon=t, device="cuda", **kw)(x, feats)
    torch.cuda.synchronize()
    grew = tuple(c.launches - b for c, b in zip(counters, before))
    assert grew == ((9, 1, 0, 0) if engine == "dcrnn" else (9, 0, 8, 0))
    want = ServingModel(cfg, var, sup, horizon=t, device="cuda", reference=True, **kw)(x, feats)
    f32 = ModelConfig(compute_dtype="float32", st_gnn=st_gnn)
    truth = ServingModel(f32, var, sup, horizon=t, device="cuda", reference=True, **kw)(x, feats)
    _assert_kernel_matches(got, want, want if dtype == "float32" else truth)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gw", [GWNetConfig(kernel_size=2), GWNetConfig(gcn_bool=False)],
                         ids=["kernel_size_2", "no_gcn"])
def test_nonfused_gwnet_engines_match_plain_engine(cuda, dtype, gw):
    """A kernel_size=2 and a gcn_bool=False Graph WaveNet served at N = 67
    (the eval-mode module: 9 DoubleConv launches per forward, neither
    Graph WaveNet kernel) against the same engine on the plain versions."""
    cfg = ModelConfig(compute_dtype=dtype, gwnet=gw)
    n, t, h = 67, 7, 32
    var = weights.init_variables(cfg, t, n, seed=0, image_size=h)
    sup = torch.from_numpy(model_supports(cfg, n))
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal((2, n, t, h, h, 1)).astype(np.float32)).to(cuda)
    feats = torch.tensor([0, 0, 0, 2022, 9, 26], dtype=torch.float32).repeat(2, t, 1).to(cuda)
    counters = (dcm.fused_double_conv, glm.gwnet_layer_forward, gsm.gwnet_stack_forward)
    before = [c.launches for c in counters]
    engine = ServingModel(cfg, var, sup, horizon=t, device="cuda")
    got = engine(x, feats)
    torch.cuda.synchronize()
    assert not engine.gwnet_stack
    assert tuple(c.launches - b for c, b in zip(counters, before)) == (9, 0, 0)
    want = ServingModel(cfg, var, sup, horizon=t, device="cuda", reference=True)(x, feats)
    f32 = ModelConfig(compute_dtype="float32", gwnet=gw)
    truth = ServingModel(f32, var, sup, horizon=t, device="cuda", reference=True)(x, feats)
    _assert_kernel_matches(got, want, want if dtype == "float32" else truth)


@pytest.mark.cuda
def test_layer_and_dcrnn_wrappers_reject_bad_inputs(cuda):
    args = _layer_args(2, 7, 3, 8, 8, 16, 2, 2, torch.float32, cuda)
    with pytest.raises(ValueError):  # non-contiguous x
        glm.gwnet_layer_forward(args[0].transpose(1, 2).contiguous().transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):  # supports in another dtype than x
        glm.gwnet_layer_forward(args[0], args[1].to(torch.bfloat16), *args[2:])
    with pytest.raises(TypeError):  # fp16 storage is not taken
        glm.gwnet_layer_forward(*(a.half() for a in args))
    x, sup, sp, kw = _dcrnn_case(False, 2, torch.float32, cuda)
    with pytest.raises(ValueError):
        dsm.dcrnn_stack_forward(x.transpose(1, 2).contiguous().transpose(1, 2), sup, sp, **kw)
    with pytest.raises(ValueError):
        dsm.dcrnn_stack_forward(x, sup.to(torch.bfloat16), sp, **kw)
    with pytest.raises(TypeError):
        dsm.dcrnn_stack_forward(x.half(), sup, sp, **kw)
    xb, supb, spb, kw = _dcrnn_case(False, 2, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="frags"):  # bf16 weights not in fragment order
        dsm.dcrnn_stack_forward(xb, supb, {k: v for k, v in spb.items() if k != "frags"}, **kw)


def test_layer_and_dcrnn_wrappers_reject_other_devices():
    """Only CPU tensors take the plain versions; another device that is
    not CUDA raises."""
    args = _layer_args(1, 5, 2, 4, 4, 8, 1, 2, torch.float32, "cpu")
    with pytest.raises(ValueError, match="device"):
        glm.gwnet_layer_forward(*(a.to("meta") for a in args))
    x, sup, sp, kw = _dcrnn_case(False, 1, torch.float32, "cpu")
    with pytest.raises(ValueError, match="device"):
        dsm.dcrnn_stack_forward(x.to("meta"), sup, sp, **kw)


def test_wrappers_reject_other_devices():
    """Only CPU tensors take the plain version; any other device that is
    not CUDA raises instead of being served by it."""
    args = _double_conv_args(1, 4, 4, 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="device"):
        dcm.fused_double_conv(*(a.to("meta") for a in args))
    x, sup, sp = _stack_inputs(ModelConfig(gwnet=SMALL), 7, 1, 2, torch.float32, "cpu")
    with pytest.raises(ValueError, match="device"):
        gsm.gwnet_stack_forward(x.to("meta"), sup, sp)
    with pytest.raises(ValueError, match="device"):
        mp.max_pool_forward(torch.zeros(1, 4, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="device"):
        mp.max_pool_backward(torch.zeros(1, 4, 4, 4, device="meta"),
                             torch.zeros(1, 2, 2, 4, device="meta"))


@pytest.mark.cuda
def test_dcrnn_teacher_step_kernels_match_plain_pool(cuda):
    """One float32 DCRNN train step at teacher_forcing 1 (N=4, T=3, B=2,
    32² frames, every pool on the kernel path) with the pool kernels and
    with their plain versions: 8 pool forwards (4 of them the eval-mode
    teacher pass) and 4 backwards, and loss, every gradient leaf and the
    BN running stats within 1e-4 of the plain step."""
    from multimodal_outage_tpu_torch.models.fusion import build_model
    from multimodal_outage_tpu_torch.train.state import create_train_state
    from multimodal_outage_tpu_torch.train.steps import make_train_step

    torch.backends.cudnn.deterministic = True
    cfg = ModelConfig(st_gnn="dcrnn", compute_dtype="float32", pool="pallas",
                      dcrnn=DCRNNConfig(teacher_forcing=1.0))
    var = weights.init_variables(cfg, 3, 4, seed=0, image_size=32)
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    batch = {"x": t(rng.standard_normal((2, 4, 3, 32, 32, 1))),
             "y": t(rng.standard_normal((2, 4, 3, 32, 32, 1))),
             "date_feats": t(np.tile([0, 0, 0, 2022, 9, 26], (2, 3, 1)))}
    sup = torch.from_numpy(model_supports(cfg, 4)).to(cuda)
    runs = []
    try:
        for plain in (False, True):
            model = weights.load_variables(build_model(cfg, 3, 4, 32, pool_reference=plain), var)
            model.to(cuda)
            mp.max_pool_forward.launches = mp.max_pool_backward.launches = 0
            loss = make_train_step(model)(create_train_state(model), batch, sup, 1e-3, 0)["loss"]
            torch.cuda.synchronize()
            launches = (mp.max_pool_forward.launches, mp.max_pool_backward.launches)
            assert launches == ((0, 0) if plain else (8, 4))
            runs.append((float(loss), {k: p.grad.clone() for k, p in model.named_parameters()
                                       if p.grad is not None},
                         {k: b.clone() for k, b in model.named_buffers()}))
    finally:
        torch.backends.cudnn.deterministic = False
    (lk, gk, sk), (lp, gp, sp) = runs
    assert abs(lk - lp) <= 1e-4 * abs(lp) and gk.keys() == gp.keys()
    for k in gp:
        assert (gk[k] - gp[k]).abs().max() <= 1e-4 * gp[k].abs().max() + 1e-7, k
    for k in sp:
        torch.testing.assert_close(sk[k], sp[k], rtol=1e-4, atol=1e-6)


def _small_store(tmp_path, n_counties=6, size=64):
    """A seeded synthetic store of the three storms at ±12 days."""
    from multimodal_outage_tpu_torch.data.store import load_store
    from multimodal_outage_tpu_torch.data.synthetic import generate_store

    generate_store(str(tmp_path), n_counties=n_counties, image_size=size, margin=12, seed=4)
    return load_store(str(tmp_path))


@pytest.mark.cuda
def test_native_gather_into_pinned_buffer(cuda, tmp_path):
    """The host gather writes straight into a pinned buffer's memory (its
    numpy view), which then copies to the card unchanged."""
    from multimodal_outage_tpu_torch.data import native

    store = _small_store(tmp_path)
    idx = np.array([0, 7, 7, store.n_dates - 1, 3], np.int64)
    pinned = torch.empty((len(idx),) + store.frames.shape[1:], dtype=torch.float32,
                         pin_memory=True)
    assert pinned.is_pinned()
    out = native.gather_frames(store.frames, idx, out=pinned.numpy())
    assert np.shares_memory(out, pinned.numpy())
    want = native.gather_frames_reference(store.frames, idx)
    np.testing.assert_array_equal(pinned.numpy(), want)
    dev = torch.empty_like(pinned, device=cuda)
    dev.copy_(pinned, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(dev.cpu(), torch.from_numpy(want))


@pytest.mark.cuda
def test_prefetch_is_stream_safe_under_a_slow_consumer(cuda, tmp_path):
    """20 batches from a depth-2 PrefetchIterator, each read on the main
    stream only after a spin kernel of ~10 ms and dropped right after that
    read is queued, bitwise equal to DevicePipeline's float32 batches. A
    batch whose memory went back to the producer's stream before the read
    ran (no record_stream), or a read that did not wait for the producer's
    event, would differ."""
    from multimodal_outage_tpu_torch.core.registry import HURRICANES
    from multimodal_outage_tpu_torch.data.dataset import WindowDataset
    from multimodal_outage_tpu_torch.data.pipeline import DevicePipeline, PrefetchIterator

    store = _small_store(tmp_path)
    ds = WindowDataset.from_case_study(store, HURRICANES, 12, 7)
    batches = [np.array([2 * k, 2 * k + 1]) % len(ds) for k in range(20)]
    pipe = DevicePipeline(store, 3.2, 10.4, 64, torch.float32, cuda)
    want = [pipe.batch(ds, b) for b in batches]
    flags = []
    for batch in PrefetchIterator(ds, iter(batches), 3.2, 10.4, 64, cuda, depth=2):
        torch.cuda._sleep(20_000_000)
        k = len(flags)
        flags.append(torch.stack([(batch[key] == want[k][key]).all()
                                  for key in ("x", "y", "date_feats")]))
        del batch
    torch.cuda.synchronize()
    assert len(flags) == 20
    assert bool(torch.stack(flags).all()), torch.stack(flags).cpu().tolist()


@pytest.mark.cuda
def test_device_store_upload_is_bitwise(cuda, tmp_path):
    """DevicePipeline's store, copied from the memmap in chunks of dates
    through one pinned buffer (several chunks here), equals the store."""
    from multimodal_outage_tpu_torch.data.pipeline import upload_frames

    store = _small_store(tmp_path)
    for chunk in (3 * store.frames[0].nbytes, 1 << 30):
        got = upload_frames(store.frames, cuda, chunk_bytes=chunk)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), torch.from_numpy(np.asarray(store.frames)))


@pytest.mark.cuda
def test_bench_serving_cli_on_the_card(cuda, capsys):
    """`bench --config serving --steps 2`: the JSON line as its last line,
    the engine's kernels 1 and 2 launched."""
    import json

    from multimodal_outage_tpu_torch import cli

    dcm.fused_double_conv.launches = gsm.gwnet_stack_forward.launches = 0
    assert cli.main(["bench", "--config", "serving", "--steps", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "serving_engine_latency" and out["value"] > 0
    assert set(out["detail"]) == {"module_eval_ms", "speedup_vs_module",
                                  "b16_throughput_tiles_per_sec"}
    assert dcm.fused_double_conv.launches > 0 and gsm.gwnet_stack_forward.launches > 0


@pytest.mark.cuda
def test_bench_dcrnn_stack_on_the_card(cuda):
    """run_benchmark("dcrnn_stack"): kernel 5 launched, every latency and
    chained device time positive, and the pair it times one function:
    kernel 5 against the module, float32, at B=1."""
    from multimodal_outage_tpu_torch import benchmarks as bm

    dsm.dcrnn_stack_forward.launches = 0
    out = bm.run_benchmark("dcrnn_stack", steps=3)
    assert dsm.dcrnn_stack_forward.launches > 0
    assert out["metric"] == "dcrnn_stack_forecast_latency"
    assert len(out["detail"]) == 8 and all(v > 0 for v in out["detail"].values())
    fns, x, c_in, cores = bm.dcrnn_stack_fns(1)
    want = fns["module"]()
    _assert_kernel_matches(fns["stack"](), want, want)
    chained = bm._chained(cores["stack"], x, c_in, cuda)()
    _assert_kernel_matches(chained[..., :want.shape[-1]], want, want)


_GLOO_CASES = (("2x1x1", (2, 1, 1)), ("1x2x1", (1, 2, 1)), ("1x1x2", (1, 1, 2)))


def _gloo_ranks_on_card():
    """One world of two ranks sharing cuda:0 runs a float32 DCRNN step on
    each mesh of _GLOO_CASES, and on 1x1x2 with remat_scope all; with the
    one-rank step on the card (deterministic cuDNN, no TF32)."""
    import spmd_rank_steps as R

    torch.backends.cudnn.allow_tf32 = False  # a module fixture runs before `cuda`
    torch.backends.cuda.matmul.allow_tf32 = False

    from multimodal_outage_tpu_torch.core.mesh import MeshShape
    from multimodal_outage_tpu_torch.parallel import launch

    t, n, h = 2, 4, 32
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((4, n, t, h, h, 1)).astype(np.float32),
             "y": rng.standard_normal((4, n, t, h, h, 1)).astype(np.float32),
             "date_feats": np.tile(np.array([0, 0, 0, 2022, 9, 26], np.float32), (4, t, 1))}
    cfg = R.model_config("dcrnn", True)
    variables = weights.init_variables(cfg, t, n, 3, h)
    cases = [(name, "dcrnn", shape, True, "b4", 4) for name, shape in _GLOO_CASES]
    cases.append(("1x1x2_remat", "dcrnn", (1, 1, 2), True, "b4", 4, {"remat_scope": "all"}))
    got = launch.run(R.mesh_steps, MeshShape(2, 1, 1), "cuda",
                     (cases, {"dcrnn": variables}, {"b4": batch}, (t, n, h)), progress=False)
    torch.backends.cudnn.deterministic = True
    try:
        ref = R.one_device_step(cfg, variables, batch, t, n, h, device="cuda")
    finally:
        torch.backends.cudnn.deterministic = False
    return got, ref


@pytest.fixture(scope="module")
def gloo_ranks_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (README: the port's tests on the H100)")
    return _gloo_ranks_on_card()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_equal_one_rank(cuda, gloo_ranks_on_card):
    """Two ranks sharing cuda:0 over gloo (parallel/launch.py picks gloo
    when a host's ranks outnumber its cards): a float32 DCRNN step on each
    of 2x1x1, 1x2x1 and 1x1x2 equals the one-rank step on the card
    (deterministic cuDNN, no TF32) at the CPU tests' bars
    (tests/test_torch_port_spmd.py)."""
    got, ref = gloo_ranks_on_card
    g_all = max(float(np.abs(v).max()) for v in ref["grads"].values())
    for name, _ in _GLOO_CASES:
        r = got[name]
        for k in ("loss", "mae", "mape", "rmse"):
            np.testing.assert_allclose(r["metrics"][k], ref["metrics"][k], rtol=1e-5)
        for k, v in ref["stats"].items():
            np.testing.assert_allclose(r["stats"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
        for k, v in ref["grads"].items():
            bar = 1e-4 * max(float(np.abs(v).max()), 1e-3 * g_all)
            assert float(np.abs(r["grads"][k] - v).max()) <= bar, (name, k)


@pytest.mark.cuda
def test_remat_on_a_time_split_mesh_on_the_card(cuda, gloo_ranks_on_card):
    """remat_scope all on 1x1x2 on the card, where autograd runs the
    backward, and with it the blocks' recompute, on its device thread:
    the recompute normalises with the time-summed moments the forward
    used, so the step equals the same mesh's step without remat bitwise
    (deterministic cuDNN, the same shapes)."""
    got, _ = gloo_ranks_on_card
    r, want = got["1x1x2_remat"], got["1x1x2"]
    assert r["metrics"] == want["metrics"]
    for part in ("stats", "grads", "params"):
        for k, v in want[part].items():
            assert np.array_equal(r[part][k], v), (part, k)
