"""Residual vector quantizer: encode and decode
(counterpart of ``audiocraft_tpu/quant/vq.py:ResidualVectorQuantizer``).

Encode runs the whole residual chain through
:func:`audiocraft_tpu_torch.ops.rvq.rvq_encode` (the CUDA kernel on the card,
its plain version on the CPU) in fp32.  Buffers sit at the reference names
``vq.layers.{q}._codebook.embed`` ...

``forward`` is the eval forward (JAX ``quant/vq.py``:148-224 with
``training=False``), which the style conditioner's bottleneck runs: the
chain over the first ``n_q_active`` codebooks through ``rvq_encode`` (K1
on the card), the sum of their vectors, the bandwidth and the commitment
penalty.  JAX's masked scan also computes codes for the inactive codebooks,
from the residual left after the active ones, and uses them nowhere; here
the codes are the active ones only.  The training forward (EMA, k-means,
dead-code expiry, quantizer dropout) waits for the training slice.
"""

from __future__ import annotations

import math
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


class QuantizedResult(tp.NamedTuple):
    """The reference ``quantization/base.py``:18-24 result."""
    x: torch.Tensor          # [B, D, T] fp32: the sum of the active codebooks' vectors
    codes: torch.Tensor      # [B, n_q_active, T] int32
    bandwidth: torch.Tensor  # kbit/s, 0-d
    penalty: torch.Tensor    # the commitment penalty, 0-d


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

    @torch.no_grad()
    def forward(self, x: torch.Tensor, frame_rate: float,
                n_q_active: tp.Optional[int] = None) -> QuantizedResult:
        """Eval forward of x [B, D, T] over the first ``n_q_active``
        codebooks (all by default): the chain's codes through
        :func:`rvq_encode`, then the vectors, their sum and the residuals in
        the chain's order; the penalty is the mean of the active layers'
        ``mean((E[idx] - r)^2)``."""
        n_q = self.n_q if n_q_active is None else int(n_q_active)
        if not 0 < n_q <= self.n_q:
            raise ValueError(f"n_q_active={n_q} is outside [1, {self.n_q}]")
        B, D, T = x.shape
        flat = x.transpose(1, 2).reshape(B * T, D).float().contiguous()
        embeds = torch.stack([layer._codebook.embed for layer in self.vq.layers[:n_q]])
        codes = rvq_encode(flat, embeds)                    # [n_q, B*T]
        residual, total = flat, torch.zeros_like(flat)
        commits = []
        for q in range(n_q):
            quantized = dequantize(codes[q], embeds[q])
            commits.append((quantized - residual).square().mean())
            residual = residual - quantized
            total = total + quantized
        bandwidth = torch.tensor(n_q * math.log2(self.bins) * frame_rate / 1000,
                                 device=x.device)
        return QuantizedResult(total.view(B, T, D).transpose(1, 2),
                               codes.view(n_q, B, T).transpose(0, 1).contiguous(), bandwidth,
                               torch.stack(commits).sum() / n_q)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T] -> [B, D, T]: the sum of the K codes' vectors."""
        B, K, T = codes.shape
        total = torch.zeros(B, T, self.dimension, device=codes.device)
        for q in range(K):
            total = total + dequantize(codes[:, q], self.vq.layers[q]._codebook.embed)
        return total.transpose(1, 2)
