"""Joint-embedding (CLAP-style) conditioning (counterpart of
``audiocraft_tpu/cond/joint_embed.py``; the reference
``JointEmbeddingConditioner``, ``modules/conditioners.py``:1006-1301).

One joint text/audio embedding a row, from a pluggable host-side
``embed_fn`` (``cond/clap.py`` builds one over a ``transformers``
``ClapModel``): ``embed_fn(x: JointEmbedCondition) -> (embeds [B, dim],
empty indices)``.  Around it: the training-time swap to ``text_embed_fn``
with probability ``text_p``, drawn from an explicit ``torch.Generator``; the
RVQ bottleneck's eval forward (``rvq``, ``quant/vq.py``: K1 on the card,
n_q 12 x 1024 bins at ``dim``; ``kmeans_init`` off, as JAX's); the output
projection ``output_proj``; and the mask, 0 for the empty rows, whose
output is zeroed.  The condition is one frame long.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..nn import init
from ..quant.vq import ResidualVectorQuantizer
from .attributes import JointEmbedCondition

ConditionType = tp.Tuple[torch.Tensor, torch.Tensor]
EmbedFn = tp.Callable[[JointEmbedCondition], tp.Tuple[np.ndarray, tp.Sequence[int]]]


def windowed_average_embedding(embed_clip_fn: tp.Callable[[np.ndarray], np.ndarray],
                               wav: np.ndarray, max_frames: int, stride: int) -> np.ndarray:
    """The mean of the clip embeddings of windows of ``max_frames`` every
    ``stride`` samples of a long waveform (reference ``_get_wav_embedding``,
    conditioners.py:1179-1212); a short one is embedded whole."""
    T = wav.shape[-1]
    if T <= max_frames:
        return embed_clip_fn(wav)
    starts = list(range(0, max(T - max_frames, 1), stride)) or [0]
    return np.mean(np.stack([embed_clip_fn(wav[..., s:s + max_frames]) for s in starts]), axis=0)


class JointEmbeddingConditioner(torch.nn.Module):
    """(embeds [B, dim], empty mask [B]) -> (condition [B, 1, output_dim],
    mask [B, 1] fp32)."""

    def __init__(self, dim: int, output_dim: int, quantize: bool = True, n_q: int = 12, bins: int = 1024, text_p: float = 0.0,
                 embed_fn: tp.Optional[EmbedFn] = None,
                 text_embed_fn: tp.Optional[EmbedFn] = None,
                 attribute: str = 'description',
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.dim, self.output_dim = dim, output_dim
        # ``attribute`` names the condition; the JAX package reads it nowhere
        self.attribute, self.quantize, self.n_q, self.bins = attribute, quantize, n_q, bins
        self.text_p, self.embed_fn, self.text_embed_fn = text_p, embed_fn, text_embed_fn
        bound = 1.0 / math.sqrt(dim)
        self.output_proj = init.linear(dim, output_dim, True, bound, generator, bias_bound=bound)
        self.rvq = ResidualVectorQuantizer(dimension=dim, n_q=n_q, bins=bins, kmeans_init=False,
                                           generator=generator) if quantize else None

    def tokenize(self, x: JointEmbedCondition, generator: tp.Optional[torch.Generator] = None,
                 training: bool = False) -> tp.Tuple[np.ndarray, np.ndarray]:
        """Host work: run the embedding model.  In training, with a
        ``generator`` and a ``text_embed_fn``, the text embedding replaces
        the audio one with probability ``text_p``."""
        if self.embed_fn is None:
            raise ValueError("JointEmbeddingConditioner needs an embed_fn (e.g. cond/clap.py)")
        use_text = (training and self.text_embed_fn is not None and generator is not None
                    and bool(torch.rand((), generator=generator) < self.text_p))
        embeds, empty_idx = (self.text_embed_fn if use_text else self.embed_fn)(x)
        mask = np.ones(embeds.shape[0], np.float32)
        mask[list(empty_idx)] = 0.0
        return np.asarray(embeds, np.float32), mask

    def forward(self, inputs: tp.Tuple[np.ndarray, np.ndarray]) -> ConditionType:
        device = self.output_proj.weight.device
        embeds = torch.as_tensor(np.asarray(inputs[0], np.float32), device=device)
        if self.rvq is not None:
            embeds = self.rvq(embeds[:, :, None], frame_rate=1.0).x[:, :, 0]
        mask = torch.as_tensor(np.asarray(inputs[1], np.float32), device=device)[:, None]
        return self.output_proj(embeds)[:, None, :] * mask[..., None], mask
