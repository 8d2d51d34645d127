"""U-net transformer: the streaming transformer stack with skip connections
from the first half of the layers to the second (counterpart of
``audiocraft_tpu/nn/unet_transformer.py``, the reference
``modules/unet_transformer.py``).

Layer ``i`` of the first half saves its output; layer ``i`` of the second
half takes the concatenation of its input and the saved output of the
mirrored layer, projected back to ``d_model`` by ``skip_projections[i %
half]`` (weights uniform in +-1/sqrt(2 d_model), biases zero).  Every
layer's self-attention routes by ``attn_kernel`` as the stack's does
(``ops/attention.kernel_route``): on the card a mask-free full-sequence call
runs the flash kernel K3f.  The JAX package's training-time skip dropout
(``layer_dropout_p``, zero by default) is not ported: nothing trains JASCO.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from . import init
from .transformer import StreamingTransformer, create_sin_embedding


class UnetTransformer(StreamingTransformer):

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 skip_connections: bool = False,
                 generator: tp.Optional[torch.Generator] = None, **kw):
        super().__init__(d_model, num_heads, num_layers, generator=generator, **kw)
        self.skip_connections = skip_connections
        if skip_connections:
            self.skip_projections = torch.nn.ModuleList(
                init.linear(2 * d_model, d_model, True, 1.0 / math.sqrt(2 * d_model), generator)
                for _ in range(num_layers // 2))

    def forward(self, x: torch.Tensor,
                cross_attention_src: tp.Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, C = x.shape
        positions = torch.arange(T, device=x.device).view(1, -1, 1)
        x = x + create_sin_embedding(positions, C).to(x.dtype)
        half = len(self.layers) // 2
        skips: tp.List[torch.Tensor] = []
        for i, layer in enumerate(self.layers):
            if self.skip_connections and i >= half:
                x = self.skip_projections[i % half](torch.cat([x, skips.pop()], dim=-1))
            x = layer(x, cross_attention_src=cross_attention_src)
            if self.skip_connections and i < half:
                skips.append(x)
        return x
