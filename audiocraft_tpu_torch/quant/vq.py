"""Residual vector quantizer: encode, decode and the training forward
(counterpart of ``audiocraft_tpu/quant/vq.py:ResidualVectorQuantizer``).

Encode runs the whole residual chain through
:func:`audiocraft_tpu_torch.ops.rvq.rvq_encode` (the CUDA kernel on the card,
its plain version on the CPU) in fp32.  Buffers sit at the reference names
``vq.layers.{q}._codebook.embed`` ...

``forward(training=False)`` is the eval forward (JAX ``quant/vq.py``:148-224
with ``training=False``), which the style conditioner's bottleneck runs: the
chain over the first ``n_q_active`` codebooks through ``rvq_encode`` (K1
on the card), the sum of their vectors, the bandwidth and the commitment
penalty.  JAX's masked scan also computes codes for the inactive codebooks,
from the residual left after the active ones, and uses them nowhere; here
the codes are the active ones only.

``forward(training=True)`` is JAX's training forward, layer by layer as its
scan runs: k-means on the first batch for a codebook whose ``inited`` is 0
(``kmeans_init``), codes from plain fp32 distances (as JAX computes them
there, not through K1), the commitment penalty, the EMA update (and
dead-code expiry) of the active layers, written into the codebook buffers in
place, and the RVQ-wide straight-through estimator (JAX ``:211-212``).  As in
JAX, codebooks past ``n_q_active`` still get codes and k-means but no EMA
and no penalty.  Each layer's random rows (k-means' start and expiry's
replacements, one draw serving both as JAX's per-layer key does) come from
``draws`` when given, else from ``generator``
(``codebook.draw_sample_indices``).  ``group`` sums the EMA statistics and
gathers the rows over the data-parallel group; the penalty is a mean over
the global batch (``dist/mesh.global_mean``).
"""

from __future__ import annotations

import math
import typing as tp

import torch

from ..dist.mesh import Group, global_mean, world_size
from ..ops.rvq import rvq_encode
from .codebook import EuclideanCodebook, dequantize, draw_sample_indices, quantize


class VectorQuantization(torch.nn.Module):
    """One quantizer layer; holds its codebook as ``_codebook``."""

    def __init__(self, dim: int, codebook_size: int,
                 generator: tp.Optional[torch.Generator] = None, **codebook):
        super().__init__()
        self._codebook = EuclideanCodebook(dim, codebook_size, generator, **codebook)


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


Draws = tp.Sequence[tp.Optional[torch.Tensor]]


class ResidualVectorQuantizer(torch.nn.Module):
    """Codes layout ``[B, K, T]``, latents ``[B, D, T]``.  The training
    fields are those of the JAX package that its training forward reads
    (reference vq.py:35-48): ``decay``, ``kmeans_init``, ``kmeans_iters`` and
    ``threshold_ema_dead_code``.  JAX's ``q_dropout``, ``commitment_weight``
    and ``orthogonal_reg_active_codes_only`` fields are read by nothing
    there and are kept only for the checkpoint config: quantizer dropout is
    the caller's ``n_q_active`` (:meth:`sample_n_q_active`) and the
    penalty's weight the train steps' ``commit_weight``.  Neither package has
    the orthogonal regularisation loss, so ``orthogonal_reg_weight > 0`` is
    refused."""

    def __init__(self, dimension: int = 256, n_q: int = 8, bins: int = 1024,
                 generator: tp.Optional[torch.Generator] = None, decay: float = 0.99,
                 kmeans_init: bool = True, kmeans_iters: int = 10,
                 threshold_ema_dead_code: float = 2.0, q_dropout: bool = False,
                 orthogonal_reg_weight: float = 0.0,
                 orthogonal_reg_active_codes_only: bool = False,
                 commitment_weight: float = 1.0):
        super().__init__()
        if orthogonal_reg_weight > 0:
            raise ValueError(f"orthogonal_reg_weight={orthogonal_reg_weight}: the orthogonal "
                             "regularisation loss is not implemented")
        self.dimension, self.n_q, self.max_n_q, self.bins = dimension, n_q, n_q, bins
        self.decay, self.kmeans_init, self.kmeans_iters = decay, kmeans_init, kmeans_iters
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.q_dropout, self.commitment_weight = q_dropout, commitment_weight
        self.orthogonal_reg_weight = orthogonal_reg_weight
        self.orthogonal_reg_active_codes_only = orthogonal_reg_active_codes_only
        codebook = dict(kmeans_init=kmeans_init, kmeans_iters=kmeans_iters, decay=decay,
                        threshold_ema_dead_code=threshold_ema_dead_code)
        self.vq = ResidualVectorQuantization(
            [VectorQuantization(dimension, bins, generator, **codebook) for _ in range(n_q)])

    def sample_n_q_active(self, generator: torch.Generator) -> int:
        """Quantizer dropout's draw (reference vq.py:78-79): uniform in
        [1, n_q].  Ranks that share the generator's seed draw the same."""
        return int(torch.randint(1, self.n_q + 1, (1,), generator=generator))

    def embeds(self) -> torch.Tensor:
        """The active codebooks stacked: [n_q, K, D]."""
        return torch.stack([layer._codebook.embed for layer in self.vq.layers[:self.n_q]])

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, D, T] -> codes [B, n_q, T] int32 (fp32 distances)."""
        B, D, T = x.shape
        flat = x.transpose(1, 2).reshape(B * T, D).float().contiguous()
        codes = rvq_encode(flat, self.embeds())          # [n_q, B*T]
        return codes.view(-1, B, T).transpose(0, 1).contiguous()

    def forward(self, x: torch.Tensor, frame_rate: float,
                n_q_active: tp.Optional[int] = None, training: bool = False,
                generator: tp.Optional[torch.Generator] = None,
                draws: tp.Optional[Draws] = None, group: Group = None,
                expiry: str = 'reference') -> QuantizedResult:
        """The eval forward (:meth:`eval_forward`), or with ``training`` the
        training forward (:meth:`train_forward`)."""
        if training:
            return self.train_forward(x, frame_rate, n_q_active, generator, draws, group, expiry)
        return self.eval_forward(x, frame_rate, n_q_active)

    def train_forward(self, x: torch.Tensor, frame_rate: float,
                      n_q_active: tp.Optional[int] = None,
                      generator: tp.Optional[torch.Generator] = None,
                      draws: tp.Optional[Draws] = None, group: Group = None,
                      expiry: str = 'reference') -> QuantizedResult:
        """JAX's training forward of x [B, D, T] (see the module note): the
        straight-through quantized latent [B, D, T] (differentiable in x),
        the codes of all ``n_q`` codebooks, the bandwidth of the active ones
        and the penalty, the mean of the active layers' commitment losses.
        The codebook buffers are updated in place.  ``draws[q]`` (row
        indices into the group's B * T rows) replaces layer q's draw from
        ``generator``."""
        n_q = self.n_q
        n_active = n_q if n_q_active is None else int(n_q_active)
        B, D, T = x.shape
        flat = x.transpose(1, 2).reshape(B * T, D).float()
        layers = [layer._codebook for layer in self.vq.layers[:n_q]]
        inited = torch.cat([cb.inited for cb in layers]).tolist()   # one host read
        n_rows = B * T * world_size(group)
        residual, total = flat, torch.zeros_like(flat)
        codes, commits = [], []
        for q, cb in enumerate(layers):
            active = q < n_active
            needs_kmeans = self.kmeans_init and not inited[q]
            needs_expiry = active and expiry == 'effective' and cb.threshold_ema_dead_code > 0
            idx = None
            if needs_kmeans or needs_expiry:
                if draws is not None:
                    idx = draws[q]
                elif generator is None:
                    raise ValueError("the training forward draws rows (k-means, expiry): pass "
                                     "a generator or draws")
                else:
                    idx = draw_sample_indices(generator, n_rows, cb.codebook_size)
            r = residual.detach()
            with torch.no_grad():
                state = cb.maybe_kmeans_init(cb.state(), r, idx, not needs_kmeans, group)
                code = quantize(r, state.embed)
                quantized = dequantize(code, state.embed)
                if active:
                    state = cb.ema_update(state, r, code, expiry, idx, group)
                if active or needs_kmeans:
                    cb.load_state_(state)
            codes.append(code)
            if active:
                commits.append(global_mean((quantized - residual).square(), group))
                residual = residual - quantized
                total = total + quantized
        out = flat + (total - flat).detach()         # RVQ-wide straight-through estimator
        bandwidth = torch.tensor(n_active * math.log2(self.bins) * frame_rate / 1000,
                                 device=x.device)
        penalty = (torch.stack(commits).sum() if commits else flat.new_zeros(())) \
            / max(n_active, 1)
        return QuantizedResult(out.view(B, T, D).transpose(1, 2),
                               torch.stack(codes).view(n_q, B, T).transpose(0, 1).contiguous(),
                               bandwidth, penalty)

    @torch.no_grad()
    def eval_forward(self, x: torch.Tensor, frame_rate: float,
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
