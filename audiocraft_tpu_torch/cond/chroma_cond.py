"""Melody conditioning by chroma (counterpart of
``audiocraft_tpu/cond/chroma_cond.py``, the reference
``ChromaStemConditioner``, ``modules/conditioners.py``:571-759).

The reference runs Demucs first to keep the vocal and other stems; the JAX
package makes stem separation an optional hook (``stem_fn`` in
``tokenize``), and so does the port; ``nn/demucs.make_stem_fn`` builds it
from the port's HTDemucs.  The rest is
the reference's: chroma extraction (``nn/chroma.py``), the nullified
condition's handling, ``match_len_on_eval`` (truncate or tile the chroma to
the training duration's length, ``chroma_len``; the mask is then all ones)
and otherwise a mask from the wav lengths over the hop
(``downsampling_factor``).  The only weights are ``output_proj``, under the
reference name.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..nn import init
from ..nn.chroma import ChromaExtractor
from .attributes import WavCondition
from .tokenizers import length_to_mask

ConditionType = tp.Tuple[torch.Tensor, torch.Tensor]


class ChromaConditioner(torch.nn.Module):
    """wav condition -> (embeds [B, frames, output_dim], mask [B, frames])."""

    def __init__(self, output_dim: int, sample_rate: int, n_chroma: int = 12,
                 radix2_exp: int = 12, duration: float = 30.0, match_len_on_eval: bool = True,
                 argmax: bool = True, generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.output_dim, self.sample_rate, self.n_chroma = output_dim, sample_rate, n_chroma
        self.duration, self.match_len_on_eval = duration, match_len_on_eval
        self.radix2_exp, self.argmax = radix2_exp, argmax
        self.chroma = ChromaExtractor(sample_rate=sample_rate, n_chroma=n_chroma,
                                      radix2_exp=radix2_exp, argmax=argmax)
        bound = 1.0 / math.sqrt(n_chroma)
        self.output_proj = init.linear(n_chroma, output_dim, True, bound, generator,
                                       bias_bound=bound)

    @property
    def dim(self) -> int:
        return self.n_chroma

    @property
    def downsampling_factor(self) -> int:
        return self.chroma._winhop

    @property
    def chroma_len(self) -> int:
        """Chroma frames of the training duration (reference :658-662)."""
        nfft, hop = self.chroma._nfft, self.chroma._winhop
        n = max(int(self.sample_rate * self.duration), nfft)
        return 1 + (n + 2 * (nfft // 2) - nfft) // hop

    def tokenize(self, x: WavCondition,
                 stem_fn: tp.Optional[tp.Callable[[np.ndarray], np.ndarray]] = None
                 ) -> WavCondition:
        """Host work: the optional stem separation hook."""
        if stem_fn is not None and x.wav.shape[-1] > 1:
            x = x._replace(wav=stem_fn(x.wav))
        return x

    def forward(self, x: WavCondition) -> ConditionType:
        device = self.output_proj.weight.device
        chroma = self.chroma(torch.as_tensor(np.asarray(x.wav), dtype=torch.float32,
                                             device=device))
        if self.match_len_on_eval:
            T, target = chroma.shape[1], self.chroma_len
            if T > target:
                chroma = chroma[:, :target]
            elif T < target:
                chroma = chroma.repeat(1, math.ceil(target / T), 1)[:, :target]
        embeds = self.output_proj(chroma.to(self.output_proj.weight.dtype))
        if self.match_len_on_eval:
            # the reference's _use_masking=False in this mode (:601-603)
            mask = torch.ones(embeds.shape[:2], dtype=torch.int32, device=device)
        else:
            lengths = (np.asarray(x.length) / self.downsampling_factor).astype(np.int64)
            mask = torch.from_numpy(length_to_mask(lengths, max_len=embeds.shape[1])
                                    .astype(np.int32)).to(device)
        return embeds * mask[..., None].to(embeds.dtype), mask
