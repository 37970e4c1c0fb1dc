"""Date2Vec periodic time embedding (reference date2vec.py:49-53).

encode(x) = concat([fc1(x), sin(fc2(x))], -1), always in float32: the raw
year (~2022) quantizes to multiples of 8 in bf16, so only the O(1)
embedding joins the compute-dtype stream (JAX serving.py:377-388).
"""

from __future__ import annotations

from typing import Dict

import torch


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
