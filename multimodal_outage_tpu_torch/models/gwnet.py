"""Graph WaveNet pieces the serving path needs outside the stack kernel."""

from __future__ import annotations

import torch


def adaptive_adjacency(
    nodevec1: torch.Tensor, nodevec2: torch.Tensor,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Learned adaptive adjacency softmax(relu(E1·E2), axis=1), computed in
    float32 (JAX models/gwnet.py:38-45; reference graph_wavenet.py:199-203)."""
    a = torch.relu(nodevec1.float() @ nodevec2.float())
    return torch.softmax(a, dim=1).to(dtype)
