"""The port's 2×2 max-pool (ops/max_pool.py, plain versions on the CPU)
against the JAX package's Pallas kernel pair max_pool_2x2_pallas in
interpret mode: forward and VJP, float32 and bfloat16, on the same numpy
inputs. Tolerance: exact equality — both sides only copy input values
(the forward a maximum, the backward the cotangent to one position per
window), so any difference is a routing fault."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_outage_tpu.ops.pool_pallas import max_pool_2x2_pallas as jax_pool
from multimodal_outage_tpu.ops.pool_pallas import supports_shape as jax_supports_shape
from multimodal_outage_tpu_torch.models.layers import max_pool_2x2
from multimodal_outage_tpu_torch.ops import max_pool as mp

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_pool_and_vjp(x: np.ndarray, g: np.ndarray, jdt):
    y, vjp = jax.vjp(lambda t: jax_pool(t, True), jnp.asarray(x, jdt))
    (dx,) = vjp(jnp.asarray(g, jdt))
    return np.asarray(y, np.float32), np.asarray(dx, np.float32)


def _port_pool_and_vjp(x: np.ndarray, g: np.ndarray, tdt):
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = mp.max_pool_2x2_pallas(xt)
    y.backward(torch.from_numpy(g).to(tdt))
    assert y.dtype == tdt and xt.grad.dtype == tdt
    return y.detach().float().numpy(), xt.grad.float().numpy()


def _assert_same(x, g, dtype):
    jdt, tdt = DTYPES[dtype]
    yj, dj = _jax_pool_and_vjp(x, g, jdt)
    yt, dt = _port_pool_and_vjp(x, g, tdt)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",
    [
        (3, 32, 32, 4),  # stem-like: W·C = 128
        (2, 2, 16, 64, 2),  # extra leading axis
        (5, 8, 64, 4),  # 40 rows: a ragged tail of the JAX 512-row block
        (3, 200, 32, 4),  # 600 rows: one full 512-row block and a tail
        (2, 16, 16, 32),  # the deepest pool's W·C = 512
    ],
)
def test_matches_jax_kernel(shape, dtype):
    """ReLU'd normals: many exact zeros, so tied windows are common."""
    rng = np.random.default_rng(sum(shape))
    x = np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
    g = rng.standard_normal(shape[:-3] + (shape[-3] // 2, shape[-2] // 2, shape[-1]))
    _assert_same(x, g.astype(np.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tie_windows_route_like_jax(dtype):
    """[[0,5],[5,0]] goes to (1,0) — F.max_pool2d and XLA's
    select-and-scatter pick (0,1) — and an all-equal window to (0,0)."""
    x = np.zeros((1, 2, 64, 2), np.float32)  # W·C = 128
    x[0, :, 0:2, :] = np.array([[0, 5], [5, 0]], np.float32)[:, :, None]
    x[0, :, 2:4, :] = 7.0
    g = np.full((1, 1, 32, 2), 3.0, np.float32)
    _assert_same(x, g, dtype)
    _, dx = _port_pool_and_vjp(x, g, DTYPES[dtype][1])
    assert dx[0, 1, 0, 0] == 3.0 and dx[0, 0, 1, 0] == 0.0  # (1,0), not (0,1)
    assert dx[0, 0, 2, 0] == 3.0 and dx[0, :, 2:4, 0].sum() == 3.0
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    torch.nn.functional.max_pool2d(tx, 2).backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    assert tx.grad[0, 0, 0, 1] == 3.0  # PyTorch's routing differs


def test_bf16_random_ties_match_jax():
    """bf16's 8-bit mantissa makes ties frequent on plain random data."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 16, 32, 4)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    xb = x.reshape(8, 8, 2, 16, 2, 4)
    window_max = xb.max(axis=(2, 4), keepdims=True)
    assert ((xb == window_max).sum(axis=(2, 4)) > 1).any()
    g = rng.standard_normal((8, 8, 16, 4)).astype(np.float32)
    _assert_same(x, g, "bfloat16")


@pytest.mark.parametrize("shape", [(2, 16, 16, 4), (2, 32, 32, 4), (3, 6, 10, 64), (1, 32, 32, 4)])
def test_layer_gate_matches_jax(shape):
    """layers.max_pool_2x2(impl="pallas") takes the kernel exactly where
    the JAX package does (W·C % 128 == 0, even H/W) and reduce_window
    elsewhere."""
    x = torch.zeros(shape)
    assert mp.supports_shape(x) == jax_supports_shape(jnp.zeros(shape))
    before = mp.max_pool_forward.launches
    y = max_pool_2x2(torch.from_numpy(
        np.random.default_rng(0).standard_normal(shape).astype(np.float32)), "pallas")
    assert tuple(y.shape) == (*shape[:-3], shape[-3] // 2, shape[-2] // 2, shape[-1])
    assert mp.max_pool_forward.launches == before  # CPU tensors launch nothing


def test_min_bytes():
    n = 8 * 128 * 128 * 4
    assert mp.min_bytes(n, 2, backward=False) == 2 * (n + n // 4)
    assert mp.min_bytes(n, 2, backward=True) == 2 * (2 * n + n // 4)
