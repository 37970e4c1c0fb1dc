"""The shared-memory layout of the per-layer Graph WaveNet kernel's bf16
body (ops/gwnet_layer.py bf16_layout, fg_column, wc_row: the Python mirror
of csrc/gwnet_layer.cu LayoutB), on the CPU: alignment for cp.async and
ldmatrix, the per-term padding of Wc, the [Wf | Wg] interleave, the fit in
one block, and a numpy walk through the padded buffers that must give
the plain layer back. The card test
tests/test_torch_port_cuda.py::test_gwnet_layer_smem_bytes_match_layout
holds the library's layout to the mirror, field by field.

Bar of the walk: float64 against the plain version in float64, 1e-12
(the same sums over zero-padded operands)."""

import numpy as np
import pytest
import torch

from multimodal_outage_tpu_torch.ops import gwnet_layer as glm

# (N, C, Cd, Cs, S, order): the full-width layer (67 counties, the default
# GWNetConfig: C = Cd = 32, Cs = 256, order 2, identity + adaptive
# supports), the small shapes of the card tests, and a shape whose rows
# are not 16-byte multiples (C = 12) and whose terms pad (Cd = 20)
SHAPES = [(67, 32, 32, 256, 2, 2), (7, 8, 8, 16, 1, 2), (9, 8, 12, 16, 3, 3),
          (19, 12, 20, 36, 2, 2)]
BUFFERS = ("x", "at", "terms", "wfg", "ws", "wc", "bias", "sup")
STRIDES = ("ld_x", "ld_at", "ld_t", "ld_fg", "ld_s", "ld_c")


@pytest.mark.parametrize("shape", SHAPES)
def test_mirror_names_every_layout_field(shape):
    """The mirror has exactly LayoutB's fields (LAYOUT_FIELDS, the order in
    which the library's gwnet_layer_bf16_layout writes them), so that the
    card test can hold it to the library field by field."""
    lay = glm.bf16_layout(*shape)
    assert sorted(lay) == sorted(glm.LAYOUT_FIELDS)
    assert len(set(glm.LAYOUT_FIELDS)) == len(glm.LAYOUT_FIELDS) == 23
    assert all(isinstance(v, int) and v >= 0 for v in lay.values())


@pytest.mark.parametrize("shape", SHAPES)
def test_offsets_and_row_strides_are_16_byte_multiples(shape):
    lay = glm.bf16_layout(*shape)
    offsets = [lay[k] for k in BUFFERS]
    assert offsets == sorted(offsets) and offsets[0] == 0
    for k in BUFFERS + ("total",):
        assert lay[k] % 16 == 0, k
    for k in STRIDES:
        # 16-byte rows for ldmatrix and cp.async; an odd number of 16-byte
        # units, so 8 consecutive rows fall in distinct banks
        assert (2 * lay[k]) % 16 == 0 and (2 * lay[k] // 16) % 2 == 1, k


@pytest.mark.parametrize("shape", SHAPES)
def test_each_wc_term_starts_at_a_multiple_of_16_rows(shape):
    n, c, cd, cs, s_count, order = shape
    lay = glm.bf16_layout(*shape)
    nt = s_count * order + 1
    assert lay["nt"] == nt and lay["Cdp"] % 16 == 0 and lay["Cdp"] >= cd
    starts = [glm.wc_row(j * cd, cd) for j in range(nt)]
    assert starts == [j * lay["Cdp"] for j in range(nt)]
    rows = [glm.wc_row(i, cd) for i in range(nt * cd)]
    assert len(set(rows)) == nt * cd and max(rows) < nt * lay["Cdp"]
    # the term buffer's columns use the same per-term padding
    assert lay["ld_t"] >= nt * lay["Cdp"]


@pytest.mark.parametrize("cd", [8, 12, 20, 32])
def test_fg_interleave_pairs_filter_and_gate(cd):
    lay = glm.bf16_layout(67, 32, cd, 256, 2, 2)
    cols = set()
    for c in range(cd):
        f, g = glm.fg_column(c, False), glm.fg_column(c, True)
        assert f // 8 == 2 * (c // 8) and g // 8 == 2 * (c // 8) + 1  # n-tiles 2q, 2q + 1
        assert f % 8 == g % 8 == c % 8  # the same slot of both
        cols.update((f, g))
    assert len(cols) == 2 * cd and max(cols) < 2 * lay["Cd8"] <= lay["ld_fg"]


@pytest.mark.parametrize("shape", SHAPES)
def test_layout_fits_one_block(shape):
    lay = glm.bf16_layout(*shape)
    assert lay["total"] <= glm.MAX_SMEM == 227 * 1024
    if shape[0] == 67:
        assert lay["total"] == 114416  # the full-width layer


def _inputs(n, c, cd, cs, s_count, order, big_bias=False, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((s_count, n, n))
    sup = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    nt = s_count * order + 1
    shapes = [(c, cd), (cd,), (c, cd), (cd,), (cd, cs), (cs,), (nt * cd, c), (c,)]
    params = [rng.standard_normal(s) * ((1 / s[0]) ** 0.5 if len(s) == 2 else 0.1) for s in shapes]
    if big_bias:  # pad rows of g = tanh(bf)·σ(bg) far from zero
        params[1] = params[1] + 3.0
        params[3] = params[3] + 3.0
    return rng.standard_normal((n, c)), sup, params


def _walk(x, sup, params, shape):
    """One (b, t) position through the bf16 body's padded buffers, in
    float64: each buffer filled as the kernel stages it (zeros, then the
    real rows and columns at bf16_layout's places), each product over the
    whole padded tile, each epilogue writing real rows and columns only."""
    n, c, cd, cs, s_count, order = shape
    lay = glm.bf16_layout(*shape)
    np_, nt, cdp = lay["Np"], lay["nt"], lay["Cdp"]
    wf, bf, wg, bg, ws, bs, wc, bc = params
    xs = np.zeros((np_, lay["ld_x"]))
    xs[:n, :c] = x
    at = np.zeros((s_count, np_, lay["ld_at"]))
    at[:, :n, :n] = sup.transpose(0, 2, 1)
    wfg = np.zeros((lay["Cp"], lay["ld_fg"]))
    bfg = np.zeros(2 * lay["Cd8"])
    for col in range(cd):
        f, g = glm.fg_column(col, False), glm.fg_column(col, True)
        wfg[:c, f], wfg[:c, g], bfg[f], bfg[g] = wf[:, col], wg[:, col], bf[col], bg[col]
    wsp = np.zeros((cdp, lay["ld_s"]))
    wsp[:cd, :cs] = ws
    wcp = np.zeros((nt * cdp, lay["ld_c"]))
    for i in range(nt * cd):
        wcp[glm.wc_row(i, cd), :c] = wc[i]
    terms = np.zeros((np_, lay["ld_t"]))
    # 1. the gated unit over the whole tile; pad rows and columns unwritten
    pre = xs[:, :lay["Cp"]] @ wfg[:, :2 * lay["Cd8"]] + bfg
    for col in range(cd):
        f, g = glm.fg_column(col, False), glm.fg_column(col, True)
        terms[:n, col] = (np.tanh(pre[:, f]) / (1 + np.exp(-pre[:, g])))[:n]
    # 2. skip projection over K = Cdp; 2-3. diffusion over K = Np
    s = (terms[:, :cdp] @ wsp[:, :lay["Cs8"]])[:n, :cs] + bs
    j = 1
    for a in range(s_count):
        src = 0
        for _ in range(order):
            out = at[a, :, :np_] @ terms[:np_, src * cdp:src * cdp + lay["Cd8"]]
            terms[:n, j * cdp:j * cdp + cd] = out[:n, :cd]
            src, j = j, j + 1
    # 4. graph-conv projection over every padded term at once
    h = (terms[:, :nt * cdp] @ wcp[:, :lay["C8"]])[:n, :c] + bc
    return h, s


@pytest.mark.parametrize("big_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_padded_walk_gives_the_plain_layer(shape, big_bias):
    n, c, cd, cs, s_count, order = shape
    x, sup, params = _inputs(*shape, big_bias=big_bias)
    if big_bias:  # what a pad row of g would hold, were it written
        bf, bg = params[1], params[3]
        assert np.abs(np.tanh(bf) / (1 + np.exp(-bg))).min() > 0.9
    h, s = _walk(x, sup, params, shape)
    t64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    hw, sw = glm.gwnet_layer_reference(t64(x)[None, :, None], t64(sup),
                                       *(t64(p) for p in params), order=order)
    np.testing.assert_allclose(h, hw[0, :, 0].numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(s, sw[0, :, 0].numpy(), rtol=1e-12, atol=1e-12)
