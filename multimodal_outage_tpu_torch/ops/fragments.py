"""Weights laid out in mma.sync m16n8k16 B-fragment order, once, on the host.

The bf16 tensor-core bodies of csrc/dcrnn_stack.cu and csrc/gwnet_stack.cu
read their weights straight from global memory (L2) as B fragments: a
fragment is one 8-byte load per lane. pack_fragments lays a stack of
[K, N] weights out in that order, padding K to 16 and N to 8 with zeros;
unpack_fragments and fragment_slot are its inverse and its index map,
for the tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """[nt, K, N] → [nt, Kp/16, Np/8, 32, 4], K padded to 16 and N to 8
    with zeros: the m16n8k16 B fragments of each term j, k-step s and
    n-tile q, lane L = 4g + t holding {w[j, 16s+2t, 8q+g], w[j, 16s+2t+1,
    8q+g], w[j, 16s+2t+8, 8q+g], w[j, 16s+2t+9, 8q+g]}, so a warp reads a
    fragment as one 8-byte load per lane (csrc/double_conv.cu's order).
    fragment_slot is the same map element by element."""
    nt, k, n = w.shape
    kp, np_ = _up(k, 16), _up(n, 8)
    wp = F.pad(w, (0, np_ - n, 0, kp - k))
    # k = 16s + 8h + 2t + p, n = 8q + g  →  [j, s, q, g, t, h, p]
    return (wp.reshape(nt, kp // 16, 2, 4, 2, np_ // 8, 8)
            .permute(0, 1, 5, 6, 3, 2, 4).reshape(nt, kp // 16, np_ // 8, 32, 4).contiguous())


def unpack_fragments(f: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """pack_fragments' inverse: [nt, Kp/16, Np/8, 32, 4] → [nt, k, n]."""
    nt, ks, nq = f.shape[:3]
    return (f.reshape(nt, ks, nq, 8, 4, 2, 2).permute(0, 1, 5, 4, 6, 2, 3)
            .reshape(nt, 16 * ks, 8 * nq)[:, :k, :n])


def fragment_slot(k: int, n: int):
    """(k-step, n-tile, lane, element) at which pack_fragments stores
    row k, column n of a term's weights."""
    kk = k % 16
    return k // 16, n // 8, 4 * (n % 8) + (kk % 8) // 2, 2 * (kk // 8) + kk % 2
