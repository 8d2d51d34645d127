"""Residual vector quantizer: encode and decode
(counterpart of ``audiocraft_tpu/quant/vq.py:ResidualVectorQuantizer``).

Encode runs the whole residual chain through
:func:`audiocraft_tpu_torch.ops.rvq.rvq_encode` (the CUDA kernel on the card,
its plain version on the CPU) in fp32.  Buffers sit at the reference names
``vq.layers.{q}._codebook.embed`` ...; ``forward``, EMA and k-means wait for
the training slice.
"""

from __future__ import annotations

import typing as tp

import torch

from ..ops.rvq import rvq_encode
from .codebook import EuclideanCodebook, dequantize


class VectorQuantization(torch.nn.Module):
    """One quantizer layer; holds its codebook as ``_codebook``."""

    def __init__(self, dim: int, codebook_size: int,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self._codebook = EuclideanCodebook(dim, codebook_size, generator)


class ResidualVectorQuantization(torch.nn.Module):
    """The stack of quantizer layers, as ``layers``."""

    def __init__(self, layers: tp.Sequence[VectorQuantization]):
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)


class ResidualVectorQuantizer(torch.nn.Module):
    """Codes layout ``[B, K, T]``, latents ``[B, D, T]``."""

    def __init__(self, dimension: int = 256, n_q: int = 8, bins: int = 1024,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.dimension, self.n_q, self.max_n_q, self.bins = dimension, n_q, n_q, bins
        self.vq = ResidualVectorQuantization(
            [VectorQuantization(dimension, bins, generator) for _ in range(n_q)])

    def embeds(self) -> torch.Tensor:
        """The active codebooks stacked: [n_q, K, D]."""
        return torch.stack([layer._codebook.embed for layer in self.vq.layers[:self.n_q]])

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, D, T] -> codes [B, n_q, T] int32 (fp32 distances)."""
        B, D, T = x.shape
        flat = x.transpose(1, 2).reshape(B * T, D).float().contiguous()
        codes = rvq_encode(flat, self.embeds())          # [n_q, B*T]
        return codes.view(-1, B, T).transpose(0, 1).contiguous()

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T] -> [B, D, T]: the sum of the K codes' vectors."""
        B, K, T = codes.shape
        total = torch.zeros(B, T, self.dimension, device=codes.device)
        for q in range(K):
            total = total + dequantize(codes[:, q], self.vq.layers[q]._codebook.embed)
        return total.transpose(1, 2)
