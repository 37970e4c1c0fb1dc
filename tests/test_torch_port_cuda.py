"""The port's kernels on the card, each held against its plain version.

Imports nothing of JAX, so it runs on a machine with the card and no JAX:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tests marked `cuda` skip where torch.cuda.is_available() is False.
Tolerances: float32 within 1e-4 (summation order only). In bfloat16 a
different summation order can move a value across a rounding boundary and
the flip propagates, so the kernel is held to the plain version's own
accuracy against the same computation in float32 (chip_smoke.py states
the same bar)."""

import numpy as np
import pytest
import torch

from multimodal_outage_tpu_torch import weights
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
@pytest.mark.parametrize("full,b,layers,k", [(True, 1, 2, 2), (True, 3, 2, 2),
                                              (False, 2, 3, 1), (False, 2, 2, 3)])
def test_dcrnn_stack_kernel_matches_plain(cuda, dtype, full, b, layers, k):
    x, sup, sp, kw = _dcrnn_case(full, b, dtype, cuda, layers, k)
    before = dsm.dcrnn_stack_forward.launches
    got = dsm.dcrnn_stack_forward(x, sup, sp, **kw)
    torch.cuda.synchronize()
    assert dsm.dcrnn_stack_forward.launches == before + 1
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
