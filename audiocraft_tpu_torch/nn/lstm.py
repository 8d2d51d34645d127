"""Multi-layer LSTM over conv layout with a skip connection
(counterpart of ``audiocraft_tpu/nn/lstm.py:StreamableLSTM``).

Each layer goes through :func:`audiocraft_tpu_torch.ops.lstm.lstm_layer`: the
hand-written recurrence kernel on a CUDA tensor, its plain version on a CPU
tensor.  Parameters sit at the ``torch.nn.LSTM`` names under ``lstm.``
(``lstm.weight_ih_l0`` ...), gate order i, f, g, o.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from ..ops.lstm import lstm_layer
from .init import uniform


class StreamableLSTM(torch.nn.Module):
    """LSTM over [B, C, T] with an additive skip connection."""

    def __init__(self, dimension: int, num_layers: int = 2, skip: bool = True,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.dimension, self.num_layers, self.skip = dimension, num_layers, skip
        H = dimension
        bound = 1.0 / math.sqrt(H)
        params = {}
        for layer in range(num_layers):
            params[f'weight_ih_l{layer}'] = uniform((4 * H, H), bound, generator)
            params[f'weight_hh_l{layer}'] = uniform((4 * H, H), bound, generator)
            params[f'bias_ih_l{layer}'] = uniform((4 * H,), bound, generator)
            params[f'bias_hh_l{layer}'] = uniform((4 * H,), bound, generator)
        self.lstm = torch.nn.ParameterDict(params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(2, 0, 1)  # [B, C, T] -> [T, B, C]
        inp = y
        for layer in range(self.num_layers):
            w = [self.lstm[f'{name}_l{layer}'].to(x.dtype)
                 for name in ('weight_ih', 'weight_hh', 'bias_ih', 'bias_hh')]
            y = lstm_layer(y, *w)
        if self.skip:
            y = y + inp
        return y.permute(1, 2, 0)
