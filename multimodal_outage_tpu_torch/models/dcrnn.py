"""DCRNN, the second st-GNN: an encoder-decoder seq2seq of diffusion-
convolutional GRU cells (the JAX package's models/dcrnn.py, eval mode).

The time loops are Python loops over the same cells the JAX package
scans with nn.scan, so the parameters sit under the key paths that scan
gives them: encoder/cell{l}/{gates,candidate}/proj/{kernel,bias},
decoder/cell{l}/…, decoder/proj/{kernel,bias}. weights.load_variables
and weights.from_flax carry a JAX tree across unchanged. The serving
engine runs the whole seq2seq as one kernel (ops/dcrnn_stack.py); this
module is its scan-path counterpart (ServingModel(dcrnn_stack=False)) and
the st-GNN that ModifiedUNet trains, with scheduled sampling (teacher
forcing) in train mode.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from multimodal_outage_tpu_torch.models.layers import Dense


class DiffusionConv(nn.Module):
    """out = proj(concat[x, T_1(A_s)x, …, T_K(A_s)x over supports s]),
    T_1 = A x, T_k = 2A·T_{k−1} − T_{k−2} (JAX models/dcrnn.py:26-57)."""

    def __init__(self, din: int, features: int, max_diffusion_step: int,
                 n_supports: int, dtype: torch.dtype):
        super().__init__()
        self.k = max_diffusion_step
        self.proj = Dense(din * (1 + n_supports * max_diffusion_step), features, dtype)

    def forward(self, x: torch.Tensor, supports: torch.Tensor) -> torch.Tensor:
        terms = [x]
        for a in supports:
            x0, x1 = x, torch.einsum("vw,bvd->bwd", a, x)
            terms.append(x1)
            for _ in range(2, self.k + 1):
                x0, x1 = x1, 2.0 * torch.einsum("vw,bvd->bwd", a, x1) - x0
                terms.append(x1)
        return self.proj(torch.cat(terms, dim=-1))


class DCGRUCell(nn.Module):
    """GRU cell whose products are diffusion convolutions (JAX
    models/dcrnn.py:60-91); the gate bias starts at 1.0."""

    def __init__(self, din: int, units: int, max_diffusion_step: int,
                 n_supports: int, dtype: torch.dtype):
        super().__init__()
        self.units = units
        self.gates = DiffusionConv(din + units, 2 * units, max_diffusion_step, n_supports, dtype)
        self.candidate = DiffusionConv(din + units, units, max_diffusion_step, n_supports, dtype)

    def forward(self, h: torch.Tensor, x: torch.Tensor, supports: torch.Tensor) -> torch.Tensor:
        ru = torch.sigmoid(self.gates(torch.cat([x, h], dim=-1), supports))
        r, u = ru[..., :self.units], ru[..., self.units:]
        c = torch.tanh(self.candidate(torch.cat([x, r * h], dim=-1), supports))
        return u * h + (1.0 - u) * c


class DCRNN(nn.Module):
    """[B, N, T, input_dim] → [B, N, horizon, output_dim]: the encoder runs
    the stacked cells over T, the decoder over the horizon from a zero GO
    symbol, feeding each step's projected output to the next
    (JAX models/dcrnn.py:156-255).

    Scheduled sampling: in train mode with teacher_forcing > 0 and
    `targets` [B, N, horizon, output_dim] given, each decoder step flips
    one coin for the whole batch with probability `tf_prob` (default
    teacher_forcing) and on heads feeds the next step target_t instead of
    its own output (JAX _DecoderStep, dcrnn.py:117-153). The horizon's
    coins are drawn at once on the host from the CPU generator `sampling`
    (the global one when None), so a Python branch picks each input and
    the step needs no device sync."""

    def __init__(self, input_dim: int, output_dim: int = 256, horizon: int = 7,
                 rnn_units: int = 64, num_rnn_layers: int = 2,
                 max_diffusion_step: int = 2, n_supports: int = 2,
                 teacher_forcing: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.output_dim, self.horizon, self.units = output_dim, horizon, rnn_units
        self.n_layers, self.teacher_forcing, self.dtype = num_rnn_layers, teacher_forcing, dtype

        def cells(d0: int) -> dict:
            return {
                f"cell{l}": DCGRUCell(d0 if l == 0 else rnn_units, rnn_units,
                                      max_diffusion_step, n_supports, dtype)
                for l in range(num_rnn_layers)
            }

        self.encoder = nn.ModuleDict(cells(input_dim))
        self.decoder = nn.ModuleDict({**cells(output_dim),
                                      "proj": Dense(rnn_units, output_dim, dtype)})

    def coins(self, tf_prob: Optional[float], sampling: Optional[torch.Generator]) -> List[bool]:
        """One coin per decoder step: heads (feed the target) with
        probability tf_prob, drawn as uniform [0, 1) < tf_prob like
        jax.random.bernoulli, so p = 0 and p = 1 are exact."""
        p = self.teacher_forcing if tf_prob is None else float(tf_prob)
        return (torch.rand(self.horizon, generator=sampling) < p).tolist()

    def forward(self, x: torch.Tensor, supports: Optional[torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None,
                targets: Optional[torch.Tensor] = None, tf_prob: Optional[float] = None,
                sampling: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` (dropout masks) is unused: DCRNN has no dropout."""
        if supports is None:
            # DCRNN has no graph-free mode: the diffusion is the model (pass
            # identity supports to turn mixing off)
            raise ValueError("DCRNN requires a supports array [S, N, N]; got None")
        dt = self.dtype
        x, sup = x.to(dt), supports.to(dt)
        b, n, t, _ = x.shape
        states = [x.new_zeros(b, n, self.units) for _ in range(self.n_layers)]
        for ti in range(t):
            inp = x[:, :, ti]
            for l in range(self.n_layers):
                states[l] = inp = self.encoder[f"cell{l}"](states[l], inp, sup)
        teacher = targets is not None and train and self.teacher_forcing > 0.0
        heads = self.coins(tf_prob, sampling) if teacher else [False] * self.horizon
        prev = x.new_zeros(b, n, self.output_dim)  # GO symbol
        outs = []
        for ti in range(self.horizon):
            inp = prev
            for l in range(self.n_layers):
                states[l] = inp = self.decoder[f"cell{l}"](states[l], inp, sup)
            out = self.decoder["proj"](inp)
            outs.append(out)
            prev = targets[:, :, ti].to(out.dtype) if heads[ti] else out
        return torch.stack(outs, dim=2)
