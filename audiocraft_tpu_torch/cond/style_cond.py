"""Style conditioning (MusicGen-Style): an audio excerpt -> EnCodec tokens
-> transformer -> RVQ bottleneck -> a downsampled prefix
(counterpart of ``audiocraft_tpu/cond/style_cond.py``; the reference
``FeatureExtractor`` and ``StyleConditioner``,
``modules/conditioners.py``:762-1003).

* The excerpt: ``length`` seconds from the middle of the wav at eval, or
  from a start drawn from an explicit ``torch.Generator`` when one is given
  and ``use_middle_of_segment`` is off (reference :835-841).
* The feature extractor is an ``EncodecModel`` of its own, fp32 in the
  MusicGen-Style builder: on the card its encode runs K5, K4 (the fp32 FMA
  variant), K2 and K1.  Like the reference, it is hidden from the state dict
  (its weights ride with the compression checkpoint); ``.to()`` and the
  other ``_apply`` moves still reach it.
* The first ``encodec_n_q`` codebooks' tokens are embedded (``embed.{i}``)
  and summed (reference :846-850), then run through a non-causal pre-norm
  transformer (``_TRANSFORMER_SCALES``, no biases, GELU; the plain
  attention path, as JAX's ``attn_kernel`` default), an affine-less eval
  batch norm with eps 1e-5 (``batch_norm.running_mean`` and
  ``running_var``), the RVQ bottleneck's eval forward over ``eval_q``
  codebooks (``rvq``, K1 on the card; reference :949-964), every
  ``ds_factor``-th frame (:966), ``output_proj``, and the mask of
  ``length / downsampling_factor`` frames.
* A nullified condition (a wav of one sample) embeds zeros.

``excerpt_mask`` is the training cross-entropy mask of the excerpt's token
span (reference :860-869).  ``set_params`` tunes the bottleneck in place
(reference :970-985) and ``with_params`` returns a copy that shares the
weights, as JAX's frozen config does.
"""

from __future__ import annotations

import copy
import math
import typing as tp

import numpy as np
import torch

from ..codec.encodec import EncodecModel
from ..nn import init
from ..nn.transformer import StreamingTransformer
from ..quant.vq import ResidualVectorQuantizer
from .attributes import WavCondition
from .tokenizers import length_to_mask

ConditionType = tp.Tuple[torch.Tensor, torch.Tensor]

_TRANSFORMER_SCALES = {
    'xsmall': dict(d_model=256, num_heads=8, num_layers=4),
    'default': dict(d_model=512, num_heads=8, num_layers=8),
    'large': dict(d_model=1024, num_heads=16, num_layers=24),
}


class _EvalBatchNorm(torch.nn.Module):
    """``(z - running_mean) / sqrt(running_var + eps)`` over the last axis,
    the reference ``BatchNorm1d(affine=False)`` at eval."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer('running_mean', torch.zeros(dim))
        self.register_buffer('running_var', torch.ones(dim))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return (z - self.running_mean) * torch.rsqrt(self.running_var + self.eps)


class StyleConditioner(torch.nn.Module):
    """wav condition -> (embeds [B, frames, output_dim], mask [B, frames])."""

    def __init__(self, feat_extractor: EncodecModel, output_dim: int = 512,
                 sample_rate: int = 32000, encodec_n_q: int = 4, length: float = 3.0,
                 transformer_scale: str = 'default', ds_factor: int = 15, n_q_out: int = 6,
                 eval_q: int = 3, bins: int = 1024, use_middle_of_segment: bool = False,
                 ds_rate_compression: int = 640, num_codebooks_lm: int = 4,
                 q_dropout: bool = True, varying_lengths: tp.Sequence[float] = (1.5, 4.5),
                 batch_norm: bool = True, rvq_threshold_ema_dead_code: float = 0.1,
                 compute_mask: bool = True, generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        # hidden from the state dict, as the reference hides it
        self.__dict__['feat_extractor'] = feat_extractor
        self.output_dim, self.sample_rate = output_dim, sample_rate
        self.encodec_n_q, self.length, self.ds_factor = encodec_n_q, length, ds_factor
        self.n_q_out, self.eval_q = n_q_out, eval_q
        self.use_middle_of_segment = use_middle_of_segment
        self.ds_rate_compression, self.num_codebooks_lm = ds_rate_compression, num_codebooks_lm
        self.transformer_scale, self.bins = transformer_scale, bins
        # read by the JAX package's training only, or nowhere: kept for the config
        self.q_dropout, self.varying_lengths = q_dropout, tuple(varying_lengths)
        self.compute_mask = compute_mask
        self.rvq_threshold_ema_dead_code = rvq_threshold_ema_dead_code
        args = _TRANSFORMER_SCALES[transformer_scale]
        self.dim = dim = args['d_model']
        self.embed = torch.nn.ModuleList(
            init.embedding(feat_extractor.cardinality, dim,
                           init.normal((feat_extractor.cardinality, dim), 0.02, generator))
            for _ in range(encodec_n_q))
        self.transformer = StreamingTransformer(
            dim_feedforward=4 * dim, causal=False, norm_first=True, bias_ff=False,
            bias_attn=False, activation='gelu', generator=generator, **args)
        self.batch_norm = _EvalBatchNorm(dim) if batch_norm else None
        # kmeans_init=False, as the JAX package's: a fresh bottleneck starts
        # from the uniform init
        self.rvq = ResidualVectorQuantizer(dimension=dim, n_q=n_q_out, bins=bins,
                                           generator=generator, kmeans_init=False,
                                           q_dropout=q_dropout,
                                           threshold_ema_dead_code=rvq_threshold_ema_dead_code)
        self.output_proj = init.linear(dim, output_dim, True, 1.0 / math.sqrt(dim), generator)

    @property
    def downsampling_factor(self) -> float:
        return (self.sample_rate / self.feat_extractor.frame_rate) * self.ds_factor

    def _apply(self, fn, *args, **kwargs):
        self.feat_extractor._apply(fn, *args, **kwargs)
        return super()._apply(fn, *args, **kwargs)

    def set_params(self, eval_q: tp.Optional[int] = None,
                   excerpt_length: tp.Optional[float] = None,
                   ds_factor: tp.Optional[int] = None,
                   encodec_n_q: tp.Optional[int] = None) -> None:
        """Tune the bottleneck in place (reference :970-985)."""
        if eval_q is not None:
            if not 0 < eval_q <= self.n_q_out:
                raise ValueError(f"eval_q={eval_q} is outside [1, {self.n_q_out}]")
            self.eval_q = eval_q
        if excerpt_length is not None:
            self.length = excerpt_length
        if ds_factor is not None:
            self.ds_factor = ds_factor
        if encodec_n_q is not None:
            if not 0 < encodec_n_q <= len(self.embed):
                raise ValueError(f"encodec_n_q={encodec_n_q} is outside [1, {len(self.embed)}]")
            self.encodec_n_q = encodec_n_q

    def with_params(self, **kwargs) -> "StyleConditioner":
        """A copy with :meth:`set_params` applied, sharing the weights."""
        out = copy.copy(self)
        out.set_params(**kwargs)
        return out

    def tokenize(self, x: WavCondition) -> WavCondition:
        return x

    def excerpt_start(self, total: int, generator: tp.Optional[torch.Generator] = None) -> int:
        """Where the excerpt starts in a wav of ``total`` samples."""
        n = min(int(self.length * self.sample_rate), total)
        if self.use_middle_of_segment or generator is None:
            return int((total - n) / 2)
        return int(torch.randint(0, total - n + 1, (1,), generator=generator))

    def excerpt_mask(self, x: WavCondition, start: int) -> tp.Optional[np.ndarray]:
        """The LM cross-entropy mask [B, num_codebooks_lm, frames], False
        over the excerpt's token span; None for a nullified condition."""
        if x.wav.shape[-1] == 1:
            return None
        total = int(x.wav.shape[-1] / self.ds_rate_compression)
        span = int(int(self.length * self.sample_rate) / self.ds_rate_compression)
        start_tok = int(start / self.ds_rate_compression)
        mask = np.ones((x.wav.shape[0], self.num_codebooks_lm, total), bool)
        mask[:, :, start_tok:start_tok + span] = False
        return mask

    def excerpt_tokens(self, wav: torch.Tensor,
                       generator: tp.Optional[torch.Generator] = None) -> torch.Tensor:
        """wav [B, C, T] -> the excerpt's codec tokens [B, encodec_n_q, T']."""
        start = self.excerpt_start(wav.shape[-1], generator)
        n = min(int(self.length * self.sample_rate), wav.shape[-1])
        tokens, _ = self.feat_extractor.encode(wav[..., start:start + n].contiguous())
        return tokens[:, :self.encodec_n_q]

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, encodec_n_q, T'] -> the bottleneck's input [B, T', dim]:
        the embeddings summed, the transformer, the batch norm."""
        z = self.transformer(sum(self.embed[q](tokens[:, q].long())
                                 for q in range(tokens.shape[1])))
        return z if self.batch_norm is None else self.batch_norm(z)

    def bottleneck(self, z: torch.Tensor) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """z [B, T', dim] -> (the RVQ's sum of ``eval_q`` codebook vectors
        [B, T', dim], its codes [B, eval_q, T'])."""
        res = self.rvq(z.transpose(1, 2), frame_rate=1.0, n_q_active=self.eval_q)
        return res.x.transpose(1, 2), res.codes

    @torch.no_grad()
    def forward(self, x: WavCondition,
                generator: tp.Optional[torch.Generator] = None) -> ConditionType:
        device = self.output_proj.weight.device
        wav = torch.as_tensor(np.asarray(x.wav), dtype=torch.float32, device=device)
        if wav.shape[-1] == 1:   # nullified condition
            embeds = torch.zeros(wav.shape[0], 1, self.dim, device=device)
        else:
            z = self.embed_tokens(self.excerpt_tokens(wav, generator))
            embeds = self.bottleneck(z)[0][:, ::self.ds_factor]
        embeds = self.output_proj(embeds)
        lengths = np.maximum((np.asarray(x.length) / self.downsampling_factor).astype(np.int64), 0)
        mask = torch.from_numpy(length_to_mask(lengths, max_len=embeds.shape[1])
                                .astype(np.int32)).to(device)
        return embeds * mask[..., None].to(embeds.dtype), mask
