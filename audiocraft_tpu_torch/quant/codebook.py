"""Euclidean codebook: the nearest-code search and lookup
(counterpart of ``audiocraft_tpu/quant/codebook.py``).

Distances keep the reference expression ``-(|x|^2 - 2 x.E^T + |E|^2)`` in
fp32, and the argmax takes the first index on ties, as ``torch.argmax`` and
``jnp.argmax`` both do.  EMA updates and k-means wait for the training slice;
until then a codebook starts from the uniform init.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from ..nn.init import uniform


def compute_distances(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Negative squared distances: x [N, D], embed [K, D] -> [N, K] fp32."""
    x = x.float()
    embed_t = embed.float().t()
    return -(x.square().sum(1, keepdim=True) - 2 * (x @ embed_t)
             + embed_t.square().sum(0, keepdim=True))


def quantize(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Nearest code per row: x [..., D] -> [...] int32."""
    flat = x.reshape(-1, x.shape[-1])
    idx = compute_distances(flat, embed).argmax(-1).to(torch.int32)
    return idx.reshape(x.shape[:-1])


def dequantize(idx: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    return embed[idx.long()]


class EuclideanCodebook(torch.nn.Module):
    """A codebook's state under the reference buffer names: ``embed`` [K, D],
    ``cluster_size`` [K], ``embed_avg`` [K, D], ``inited`` [1]."""

    def __init__(self, dim: int, codebook_size: int,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        # kaiming-uniform bound with gain sqrt(2), as the JAX uniform_init
        embed = uniform((codebook_size, dim), math.sqrt(2.0) * math.sqrt(3.0 / dim),
                        generator).data
        self.register_buffer('embed', embed)
        self.register_buffer('cluster_size', torch.zeros(codebook_size))
        self.register_buffer('embed_avg', embed.clone())
        self.register_buffer('inited', torch.ones(1))
