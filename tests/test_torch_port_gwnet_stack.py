"""The Graph WaveNet stack's weights in mma.sync fragment order
(ops/gwnet_stack.py stack_fragments), read back on the CPU.

The kernel's bf16 body reads every weight as packed B fragments; a wrong
index there shows only on the card. So each packed weight is read back
element by element through the packer's index map (fragment_slot) and
through its inverse (unpack_fragments), at full width, at the narrow
test widths and at widths that pad every tile, and the filter and gate
columns are checked to land in the same lane and element slot."""

import numpy as np
import pytest
import torch

from multimodal_outage_tpu_torch.ops import fragments as fr
from multimodal_outage_tpu_torch.ops import gwnet_stack as gsm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this file's small torch ops: with the
    suite's workers sharing the cores, OpenMP's barriers otherwise stall
    each op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (Cin, C, Cd, Cs, Ce, Cout, L, S, order): the default config, the narrow
# test config, widths that pad every tile, and 3 supports at order 3
WIDTHS = {
    "full": (320, 32, 32, 256, 512, 256, 8, 2, 2),
    "small": (24, 8, 8, 16, 32, 20, 4, 2, 2),
    "padded": (24, 12, 12, 20, 36, 20, 8, 2, 2),
    "three_supports": (24, 8, 12, 16, 32, 20, 2, 3, 3),
}


def _up(v, m):
    return -(-v // m) * m


def _params(name):
    """Stack params of these widths in bf16 (random, from numpy), with
    their fragments."""
    cin, c, cd, cs, ce, cout, n_layers, s_count, order = WIDTHS[name]
    rng = np.random.default_rng(len(name))
    r = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    nt = s_count * order + 1
    sp = {
        "start_w": r(cin, c), "start_b": r(c), "wfg": r(n_layers, c, 2 * cd),
        "bfg": r(n_layers, 2 * cd), "ws": r(n_layers, cd, cs), "bs": r(n_layers, cs),
        "wc": r(n_layers, nt * cd, c), "bc": r(n_layers, c), "aa": r(n_layers, c),
        "ab": r(n_layers, c), "e1w": r(cs, ce), "e1b": r(ce), "e2w": r(ce, cout), "e2b": r(cout),
    }
    sp = {k: v if k in ("bc", "aa", "ab") else v.to(torch.bfloat16) for k, v in sp.items()}
    sp["frags"] = gsm.stack_fragments(sp)
    return sp, nt


def _logical(sp, name):
    """(packed name, [terms, K, N] weights, row map, column map): the
    weight, and where its row k and column n sit in the packed matrix."""
    cd = sp["wfg"].shape[2] // 2
    ident = lambda i: i
    if name == "wfg":  # filter columns, then gate columns, interleaved
        cols = lambda n: np.where(n < cd, gsm.interleaved_column(n % cd, False),
                                  gsm.interleaved_column(n % cd, True))
        return "wfg", sp["wfg"], ident, cols
    if name == "wc":  # each term's rows padded to 16
        return "wc", sp["wc"], lambda k: k // cd * _up(cd, 16) + k % cd, ident
    w = {"start": sp["start_w"][None], "ws": sp["ws"], "e1": sp["e1w"][None],
         "e2": sp["e2w"][None]}[name]
    return name, w, ident, ident


@pytest.mark.parametrize("weight", ["start", "wfg", "ws", "wc", "e1", "e2"])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_stack_fragments_read_back_exactly(widths, weight):
    """Every element of every packed weight, read through fragment_slot,
    is the weight's element; unpacking gives the padded matrix back with
    zeros in every pad row and column."""
    sp, nt = _params(widths)
    name, w, rows, cols = _logical(sp, weight)
    f = sp["frags"][name]
    gsm._check_fragments(sp, nt)  # the shapes the kernel's wrapper expects
    k, n = np.arange(w.shape[1])[:, None], np.arange(w.shape[2])[None, :]
    s, q, lane, e = fr.fragment_slot(rows(k), cols(n))
    idx = [torch.from_numpy(np.broadcast_to(v, (w.shape[1], w.shape[2])).copy())
           for v in (s, q, lane, e)]
    assert torch.equal(f[:, idx[0], idx[1], idx[2], idx[3]], w)
    kp, np_ = 16 * f.shape[1], 8 * f.shape[2]
    full = fr.unpack_fragments(f, kp, np_)
    placed = torch.zeros_like(full)
    placed[:, torch.from_numpy(np.broadcast_to(rows(k), w.shape[1:]).copy()),
           torch.from_numpy(np.broadcast_to(cols(n), w.shape[1:]).copy())] = w
    assert torch.equal(full, placed)  # the weight where it belongs, zeros elsewhere


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_filter_and_gate_columns_share_lane_and_slot(widths):
    """In the interleaved [Wf | Wg] packing, filter column c and gate
    column c sit at the same k-step, lane and element, in n-tiles 2q and
    2q + 1, so one lane's two accumulator fragments hold both."""
    sp, _ = _params(widths)
    f, (n_layers, c_in, cd2) = sp["frags"]["wfg"], sp["wfg"].shape
    cd = cd2 // 2
    assert f.shape[2] == 2 * (_up(cd, 8) // 8)
    for c in range(cd):
        for k in range(c_in):
            sf, qf, lf, ef = fr.fragment_slot(k, gsm.interleaved_column(c, False))
            sg, qg, lg, eg = fr.fragment_slot(k, gsm.interleaved_column(c, True))
            assert (sf, lf, ef) == (sg, lg, eg) and (qf, qg) == (2 * (c // 8), 2 * (c // 8) + 1)
            assert torch.equal(f[:, sf, qf, lf, ef], sp["wfg"][:, k, c])
            assert torch.equal(f[:, sg, qg, lg, eg], sp["wfg"][:, k, cd + c])


def test_wrapper_checks_fragments_and_plain_version_ignores_them():
    """The fragment check refuses a missing or mis-shaped fragment; the
    plain version and the bytes bound read only the row-major weights."""
    sp, nt = _params("padded")
    with pytest.raises(ValueError, match="frags"):
        gsm._check_fragments({k: v for k, v in sp.items() if k != "frags"}, nt)
    bad = dict(sp, frags=dict(sp["frags"], e2=sp["frags"]["e2"][:, :1].contiguous()))
    with pytest.raises(ValueError, match="frags.e2"):
        gsm._check_fragments(bad, nt)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, 3, 24)).astype(np.float32)).to(torch.bfloat16)
    sup = torch.from_numpy(rng.uniform(0, 0.2, (2, 9, 9)).astype(np.float32)).to(torch.bfloat16)
    plain = {k: v for k, v in sp.items() if k != "frags"}
    assert torch.equal(gsm.gwnet_stack_forward(x, sup, sp), gsm.gwnet_stack_forward(x, sup, plain))
    assert gsm.min_bytes(x, sup, sp, 20) == gsm.min_bytes(x, sup, plain, 20)
