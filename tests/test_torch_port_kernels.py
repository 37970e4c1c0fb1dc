"""The port's two kernel modules against the JAX package's TPU kernels.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the Pallas kernels in interpret mode and against the JAX plain
references, with inputs made by numpy from a seed. The kernel-vs-plain
tests need the card and live in test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.models.gwnet import GraphWaveNet
from multimodal_outage_tpu.ops import gwnet_stack_pallas as jstack
from multimodal_outage_tpu.ops import unet_pallas as junet
from multimodal_outage_tpu_torch.ops import double_conv as dcm
from multimodal_outage_tpu_torch.weights import from_flax
from multimodal_outage_tpu_torch.ops import gwnet_stack as gsm


def _double_conv_inputs(m, h, cin, c, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        rng.standard_normal((m, h, h, cin)).astype(f),
        (rng.standard_normal((3, 3, cin, c)) * 0.2).astype(f),
        rng.uniform(0.5, 1.5, c).astype(f),
        (rng.standard_normal(c) * 0.1).astype(f),
        (rng.standard_normal((3, 3, c, c)) * 0.2).astype(f),
        rng.uniform(0.5, 1.5, c).astype(f),
        (rng.standard_normal(c) * 0.1).astype(f),
    )


# Cin=1 (the U-Net stem) and Cin=2C (an expansion block's concat input)
@pytest.mark.parametrize("m,h,cin,c", [(3, 16, 1, 4), (2, 8, 16, 8)])
def test_double_conv_reference_matches_jax(m, h, cin, c):
    args = _double_conv_inputs(m, h, cin, c, seed=cin)
    want_pallas = junet.fused_double_conv(*map(jnp.asarray, args), True)
    want_ref = junet.forward_reference(*map(jnp.asarray, args))
    got = dcm.double_conv_reference(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=2e-5)


def test_double_conv_wrapper_on_cpu_runs_plain_version():
    args = tuple(map(torch.from_numpy, _double_conv_inputs(2, 8, 4, 8, seed=0)))
    before = dcm.fused_double_conv.launches
    out = dcm.fused_double_conv(*args)
    assert dcm.fused_double_conv.launches == before  # no kernel launched
    torch.testing.assert_close(out, dcm.double_conv_reference(*args), rtol=0, atol=0)


def test_double_conv_reference_rounds_intermediate_like_tpu_kernel():
    """In bf16 the intermediate is rounded after the first ReLU
    (unet_pallas.py:70): the port's plain version agrees with the JAX
    plain reference to bf16 resolution."""
    args = _double_conv_inputs(2, 8, 4, 8, seed=5)
    x = jnp.asarray(args[0]).astype(jnp.bfloat16)
    want = junet.forward_reference(x, *map(jnp.asarray, args[1:]))
    xt = torch.from_numpy(args[0]).to(torch.bfloat16)
    w1, s1, b1, w2, s2, b2 = map(torch.from_numpy, args[1:])
    got = dcm.double_conv_reference(
        xt, w1.to(torch.bfloat16), s1, b1, w2.to(torch.bfloat16), s2, b2
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=2e-2, atol=2e-2,
    )


@pytest.mark.parametrize("h,cin,c", [(128, 1, 4), (8, 32, 64), (16, 64, 32)])
def test_pick_tile_fits_shared_memory(h, cin, c):
    th, tw, smem = dcm.pick_tile(h, h, cin, c)
    assert th <= h and tw <= h and smem <= 227 * 1024


# (H, Cin, C) of the 9 DoubleConvs of a serving forward
SERVING_SHAPES = [(128, 1, 4), (64, 4, 8), (32, 8, 16), (16, 16, 32), (8, 32, 64),
                  (16, 64, 32), (32, 32, 16), (64, 16, 8), (128, 8, 4)]
H100_SMEM = 232_448  # dynamic shared memory one block may have


@pytest.mark.parametrize(
    "m,h,w,cin,c",
    [(m, h, h, cin, c) for m in (469, 7504) for h, cin, c in SERVING_SHAPES]
    + [(3, 20, 12, 64, 32), (1, 12, 20, 8, 4), (2, 7, 5, 3, 12), (1, 1, 1, 1, 4),
       (5, 33, 17, 20, 36), (1, 8, 8, 4, 68)],
)
def test_bf16_plan_fits_and_pads(m, h, w, cin, c):
    """The bf16 tile planner: the shared memory it reckons fits a block,
    K is padded to whole chunks of 16, N to 8 × a power of two, and the
    persistent grid never exceeds the work items."""
    p = dcm.plan_bf16(m, h, w, cin, c)
    assert p.smem <= H100_SMEM and p.smem % 16 == 0
    assert 1 <= p.th <= min(h, 32) and 1 <= p.tw <= min(w, 32)
    assert p.cp1 >= cin and p.cp2 >= c and p.cp1 % 2 == 0 and p.cp2 % 2 == 0
    assert (p.cp1 in (2, 4, 8) or p.cp1 % 16 == 0) and (p.cp2 in (2, 4, 8) or p.cp2 % 16 == 0)
    taps = 3 * (2 + p.px)  # 3 × 3, or 3 × 4 for two pixels per GEMM row
    assert p.px == (2 if c == 4 and p.tw % 2 == 0 else 1)
    assert 16 * p.kc1 >= taps * p.cp1 > 16 * (p.kc1 - 1)
    assert 16 * p.kc2 >= taps * p.cp2 > 16 * (p.kc2 - 1)
    n = p.px * p.npad  # N columns: px pixels × npad channels
    assert n % 8 == 0 and (n // 8) & (n // 8 - 1) == 0 and p.npad >= c and p.npad >= p.cp2
    assert p.items == m * -(-h // p.th) * -(-w // p.tw)
    for per_sm in (1, 2, 8):
        assert 1 <= dcm.bf16_grid(p.items, 132, per_sm) <= p.items


def test_bf16_plan_at_the_deep_serving_shapes():
    """The whole image is one tile at 8² and 16²; the two deepest shapes
    take the most shared memory, the rest stay small."""
    sizes = {(h, cin, c): dcm.plan_bf16(469, h, h, cin, c) for h, cin, c in SERVING_SHAPES}
    assert (sizes[(8, 32, 64)].th, sizes[(16, 64, 32)].th) == (8, 16)
    assert 140_000 <= sizes[(8, 32, 64)].smem <= 160_000
    assert 180_000 <= sizes[(16, 64, 32)].smem <= 210_000
    # two blocks fit an SM's 228 KB at every other shape
    assert all(p.smem <= 110_000 for k, p in sizes.items() if k not in ((8, 32, 64), (16, 64, 32)))


def test_bf16_plan_keeps_register_staging_in_bounds():
    """Without cp.async (Cin % 4 != 0) a thread holds at most 4 words of
    the next input tile: the planner shrinks the tile until it does."""
    for cin in (1, 2, 3, 5, 6, 7, 9, 13, 30):
        p = dcm.plan_bf16(2, 64, 64, cin, 16)
        assert (p.th + 4) * (p.tw + 4) * p.cp1 // 2 <= 4 * 256, cin


@pytest.mark.parametrize("cin,c", [(4, 6), (8, 136), (512, 128)])
def test_bf16_plan_refuses_what_the_kernel_cannot_take(cin, c):
    with pytest.raises(ValueError):
        dcm.plan_bf16(1, 16, 16, cin, c)
    with pytest.raises(ValueError):
        dcm.bf16_grid(10, 132, 0)


def _pad(t, dims):
    """Zero-pad the trailing len(dims) axes of t up to dims."""
    pad = []
    for have, want in reversed(list(zip(t.shape[-len(dims):], dims))):
        pad += [0, want - have]
    return torch.nn.functional.pad(t, pad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,cin,c", [(8, 1, 4), (8, 4, 8), (6, 12, 20), (5, 32, 36)])
def test_reference_with_kernel_padding_is_exact(dtype, h, cin, c):
    """The channel padding the bf16 kernel relies on: x to cp1 channels,
    w1 to [3,3,cp1,npad], w2 to [3,3,npad,npad], the affine to npad, all
    zeros (at C = 4 none in N: a GEMM row holds two pixels instead). The plain version on the padded inputs, sliced back to C,
    equals it on the unpadded ones exactly, and the pad channels are 0.
    Small integer data and dyadic affines make every sum exact in any
    order."""
    rng = np.random.default_rng(h + cin + c)
    ints = lambda *s: torch.from_numpy(rng.integers(-1, 2, s).astype(np.float32))
    dyad = lambda *v: torch.from_numpy(rng.choice(np.float32(v), c))
    x, w1, w2 = ints(2, h, h, cin).to(dtype), ints(3, 3, cin, c).to(dtype), ints(3, 3, c, c).to(dtype)
    s1, s2, b1, b2 = dyad(0.5, 1, 2), dyad(0.25, 0.5, 1), dyad(-0.5, 0, 0.5), dyad(-0.25, 0, 1)
    p = dcm.plan_bf16(2, h, h, cin, c)
    want = dcm.double_conv_reference(x, w1, s1, b1, w2, s2, b2)
    got = dcm.double_conv_reference(
        _pad(x, [p.cp1]), _pad(w1, [p.cp1, p.npad]), _pad(s1, [p.npad]), _pad(b1, [p.npad]),
        _pad(w2, [p.npad, p.npad]), _pad(s2, [p.npad]), _pad(b2, [p.npad]))
    assert float(want.float().abs().max()) > 0
    torch.testing.assert_close(got[..., :c], want, rtol=0, atol=0)
    assert not got[..., c:].any()


N, T, CIN = 7, 5, 24


def _gwnet_module_and_variables(addaptadj, b=2):
    """The set-up of tests/test_gwnet_stack.py, inputs made by numpy."""
    m = GraphWaveNet(
        out_dim=20, residual_channels=8, dilation_channels=8,
        skip_channels=16, end_channels=32, blocks=2, layers=2, dropout=0.0,
        order=2, addaptadj=addaptadj, node_embed_dim=4, dtype=jnp.float32,
    )
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, N, T, CIN)).astype(np.float32)
    logits = rng.standard_normal((1, N, N))
    sup = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    variables = m.init({"params": key, "dropout": key}, x, sup, train=False)
    bs = jax.tree.map(
        lambda v: np.asarray(rng.normal(0.1, 0.3, v.shape) ** 2 + 0.5, np.float32),
        variables["batch_stats"],
    )
    return m, {"params": variables["params"], "batch_stats": bs}, x, sup


@pytest.mark.parametrize("addaptadj", [True, False])
def test_stack_reference_matches_jax_kernel(addaptadj):
    m, variables, x, sup = _gwnet_module_and_variables(addaptadj)
    n_layers = m.blocks * m.layers
    p = variables["params"]
    jsp = jstack.stack_params_from_module(p, variables["batch_stats"], n_layers)
    jsup = jstack.adaptive_supports(
        jnp.asarray(sup), p.get("nodevec1"), p.get("nodevec2")
    )
    want = jstack.gwnet_stack_forward(
        jnp.asarray(x), jsup, jsp, order=m.order, interpret=True
    )
    y_module = m.apply(variables, x, sup, train=False)

    tp, tbs = from_flax(p), from_flax(variables["batch_stats"])
    sp = gsm.stack_params_from_module(tp, tbs, n_layers)
    tsup = gsm.adaptive_supports(
        torch.from_numpy(sup), tp.get("nodevec1"), tp.get("nodevec2")
    )
    np.testing.assert_allclose(tsup.numpy(), np.asarray(jsup), atol=1e-7)
    got = gsm.gwnet_stack_forward(torch.from_numpy(x), tsup, sp, order=m.order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_module), atol=3e-5, rtol=1e-4)


def test_stack_params_layout():
    m, variables, _, _ = _gwnet_module_and_variables(True)
    sp = gsm.stack_params_from_module(
        from_flax(variables["params"]), from_flax(variables["batch_stats"]),
        m.blocks * m.layers, dtype=torch.bfloat16,
    )
    assert sp["wfg"].shape == (4, 8, 16) and sp["wc"].shape == (4, 5 * 8, 8)
    assert sp["bc"].dtype == sp["aa"].dtype == sp["ab"].dtype == torch.float32
    assert sp["wfg"].dtype == sp["e2w"].dtype == torch.bfloat16
