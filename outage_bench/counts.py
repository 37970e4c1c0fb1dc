"""The yardstick's arithmetic, frozen here so that no change to the program
moves it: each kernel's operations and compulsory bytes from the shapes of
the configuration, the card's peaks, and the FLOPs of a forward or a train
step counted over the plain reference.

A kernel's bound is max(operations / peak tensor rate, bytes / peak
bandwidth), each input counted read once and each output written once, in
the compute dtype, whatever implements the layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# published dense bf16 tensor rate and HBM bandwidth, keyed on a lowercase
# substring of torch.cuda.get_device_name()
PEAKS = {
    "h100 80gb hbm3": (989e12, 3.35e12),  # H100 SXM
}


def peaks(device_name: str) -> Optional[Tuple[float, float]]:
    name = device_name.lower()
    for sub, p in PEAKS.items():
        if sub in name:
            return p
    return None


def bound_s(flops: float, nbytes: float, pk: Tuple[float, float]) -> float:
    return max(flops / pk[0], nbytes / pk[1])


# --- kernel 1: DoubleConv (conv3x3 -> affine -> ReLU, twice) --------------

def double_conv_flops(m: int, h: int, w: int, cin: int, c: int) -> int:
    """Multiply-adds x2 of one call."""
    return 2 * m * h * w * 9 * (cin * c + c * c)


def double_conv_bytes(m: int, h: int, w: int, cin: int, c: int, itemsize: int) -> int:
    """x and the weights read once, out written once, the float32 affine
    vectors read once."""
    return itemsize * (m * h * w * (cin + c) + 9 * c * (cin + c)) + 4 * 4 * c


def double_conv_shapes(model: Dict, image_size: int) -> List[Tuple[int, int, int, int]]:
    """(h, w, cin, c) of each DoubleConv of a forward, contraction then
    expansion."""
    base, depth, cin = model["base_channels"], model["depth"], model["input_channels"]
    out = [(image_size, image_size, cin, base)]
    ch, s = base, image_size
    for _ in range(depth):
        s //= 2
        out.append((s, s, ch, 2 * ch))
        ch *= 2
    for _ in range(depth):
        s *= 2
        out.append((s, s, ch, ch // 2))  # concat(skip ch/2, up ch/2) -> ch/2
        ch //= 2
    return out


# --- kernel 2: the whole eval-mode Graph WaveNet stack --------------------

def gwnet_stack_counts(model: Dict, b: int, n: int, t: int, n_supports: int,
                       itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of one call at kernel_size 1 with BatchNorm
    folded; n_supports counts the static and the adaptive support."""
    g = model["gwnet"]
    cin = model["feature_vector_size"] + model["time_embed_size"]
    c, cd, cs, ce = (g["residual_channels"], g["dilation_channels"], g["skip_channels"],
                     g["end_channels"])
    cout, order, layers = model["feature_vector_size"], g["order"], g["blocks"] * g["layers"]
    nt = n_supports * order + 1
    per_layer = (n * c * 2 * cd + n * cd * cs + n_supports * order * n * n * cd
                 + n * nt * cd * c)
    flops = 2 * b * t * (n * cin * c + layers * per_layer + n * cs * ce + n * ce * cout)
    weights = (cin * c + c
               + layers * (2 * (c * cd + cd) + cd * cs + cs + nt * cd * c + c + 2 * c)
               + cs * ce + ce + ce * cout + cout)
    nbytes = itemsize * (b * n * t * (cin + cout) + n_supports * n * n + weights)
    return flops, nbytes


# --- kernel 5: the whole DCRNN seq2seq ------------------------------------

def dcrnn_stack_counts(model: Dict, b: int, n: int, t: int, horizon: int, n_supports: int,
                       itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of one call. The decoder's first step has the
    zero GO symbol as input, whose x part contributes nothing."""
    d = model["dcrnn"]
    dx0 = model["feature_vector_size"] + model["time_embed_size"]
    dout, units, layers = model["feature_vector_size"], d["rnn_units"], d["num_rnn_layers"]
    order = d["max_diffusion_step"]
    nt = n_supports * order + 1

    def cell(dx: int, x: bool = True) -> int:
        dd = (dx if x else 0) + 2 * units  # x, h and r*h chains
        chains = n_supports * order * n * n * dd
        proj = nt * n * ((dx * 3 * units if x else 0) + units * 2 * units + units * units)
        return chains + proj

    per_step = lambda d0, x=True: cell(d0, x) + (layers - 1) * cell(units)
    macs = (t * per_step(dx0) + (horizon - 1) * per_step(dout) + per_step(dout, False)
            + horizon * n * units * dout)
    weights = 0
    for d0 in (dx0, dout):
        for l in range(layers):
            dx = d0 if l == 0 else units
            weights += nt * (dx + units) * 3 * units + 3 * units
    weights += units * dout + dout
    nbytes = itemsize * (b * n * t * dx0 + b * n * horizon * dout + n_supports * n * n + weights)
    return 2 * b * macs, nbytes


# --- whole forwards and steps, counted over the plain reference -----------

def reference_flops(fn) -> float:
    """FlopCounterMode over one call of fn (matrix products and
    convolutions, forward and backward, a multiply-add as 2). Run it on
    the plain reference on the meta device: no memory, no time."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())

