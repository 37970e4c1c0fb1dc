"""Date2Vec periodic time embedding (reference date2vec.py:49-53).

encode(x) = concat([fc1(x), sin(fc2(x))], -1), always in float32: the raw
year (~2022) quantizes to multiples of 8 in bf16, so only the O(1)
embedding joins the compute-dtype stream (JAX serving.py:377-388,
models/fusion.py:141-156).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from multimodal_outage_tpu_torch.models.layers import Dense


def encode(date_feats: torch.Tensor, params: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """[..., 6] raw (0,0,0,y,m,d) features → [..., k] float32 embedding.

    params: the date2vec subtree, Dense kernels as [in, out]."""
    x = date_feats.float()
    fc1, fc2 = params["fc1"], params["fc2"]
    return torch.cat(
        [
            x @ fc1["kernel"].float() + fc1["bias"].float(),
            torch.sin(x @ fc2["kernel"].float() + fc2["bias"].float()),
        ],
        dim=-1,
    )


class Date2Vec(nn.Module):
    """The embedding as a module of the trainable model, float32. Frozen
    unless `trainable` (the JAX package's stop_gradient when
    train_date2vec is off): its parameters then take no gradient and no
    optimizer step changes them."""

    def __init__(self, k: int = 64, trainable: bool = False):
        super().__init__()
        self.fc1 = Dense(6, k // 2)
        self.fc2 = Dense(6, k // 2 + k % 2)
        self.requires_grad_(trainable)

    def forward(self, date_feats: torch.Tensor) -> torch.Tensor:
        return encode(date_feats, {
            "fc1": {"kernel": self.fc1.kernel, "bias": self.fc1.bias},
            "fc2": {"kernel": self.fc2.kernel, "bias": self.fc2.bias},
        })
