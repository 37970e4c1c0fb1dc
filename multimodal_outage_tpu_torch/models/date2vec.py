"""Date2Vec periodic time embedding (reference date2vec.py:49-53).

encode(x) = concat([fc1(x), sin(fc2(x))], -1), always in float32: the raw
year (~2022) quantizes to multiples of 8 in bf16, so only the O(1)
embedding joins the compute-dtype stream (JAX serving.py:377-388,
models/fusion.py:141-156). Date2VecAutoencoder adds the head that
pretraining reconstructs the date through (train/date2vec_pretrain.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from multimodal_outage_tpu_torch.models.layers import Dense, dropout


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


class Date2VecAutoencoder(nn.Module):
    """The full Date2Vec autoencoder, used only for pretraining (JAX
    models/date2vec.py:53-85, reference date2vec.py:33-47), float32:

        e = [fc1(x) ‖ d2(sin(fc2(x)))],  x̂ = fc5(fc4(d3(fc3(e))))

    fc1, fc2 are the encoder the fusion model keeps; fc3 (k → k/2), fc4
    (k/2 → 6) and fc5 (6 → 6) the head; d2 and d3 dropout 0.3, their masks
    drawn from an explicit generator."""

    rate = 0.3

    def __init__(self, k: int = 64):
        super().__init__()
        self.fc1 = Dense(6, k // 2)
        self.fc2 = Dense(6, k // 2 + k % 2)
        self.fc3 = Dense(k, k // 2)
        self.fc4 = Dense(k // 2, 6)
        self.fc5 = Dense(6, 6)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[..., 6] → the [..., 6] reconstruction."""
        x = x.float()
        e = torch.cat(
            [self.fc1(x), dropout(torch.sin(self.fc2(x)), self.rate, train, generator)], dim=-1
        )
        return self.fc5(self.fc4(dropout(self.fc3(e), self.rate, train, generator)))
