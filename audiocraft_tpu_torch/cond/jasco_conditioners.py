"""JASCO's symbolic and drum conditioners and their provider (counterpart
of ``audiocraft_tpu/cond/jasco_conditioners.py``, the reference
``modules/jasco_conditioners.py``).

* :class:`MelodyConditioner`: a salience matrix [B, card, T] projected by
  ``output_proj``.
* :class:`ChordsEmbConditioner`: frame-level chord ids through ``emb``, a
  table of ``card + 1`` rows, the last the null chord that dropout uses.
* :class:`DrumsConditioner`: the drum stem (the ``stem_fn`` hook of
  ``tokenize``: Demucs, ``nn/demucs.make_stem_fn(stems=('drums',))``)
  encoded by its codec (on the card the fused route: K5, K4, K2, K1), only
  the first codebook decoded back to a latent, blurred over spans of
  ``blurring_factor`` frames (a mirrored tail pads the last span) and
  projected; a nullified wav (one sample) gives zeros.  The codec is hidden
  from the state dict, as the reference hides it.
* :class:`JascoConditioningProvider`: collates text, chords (padded with the
  null chord), melodies (zero-padded) and wavs to ``sequence_length``
  frames.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..codec.encodec import EncodecModel
from ..nn import init
from .attributes import ConditioningAttributes, SymbolicCondition, WavCondition
from .conditioners import ConditioningProvider, collate_wav_conditions

ConditionType = tp.Tuple[torch.Tensor, torch.Tensor]


def _proj(in_d: int, out_d: int, generator: tp.Optional[torch.Generator]) -> torch.nn.Linear:
    bound = 1.0 / math.sqrt(in_d)
    return init.linear(in_d, out_d, True, bound, generator, bias_bound=bound)


def _ones_mask(embeds: torch.Tensor) -> torch.Tensor:
    return torch.ones(embeds.shape[:2], dtype=torch.int32, device=embeds.device)


class MelodyConditioner(torch.nn.Module):

    def __init__(self, card: int, out_dim: int,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.card, self.out_dim = card, out_dim
        self.output_proj = _proj(card, out_dim, generator)

    def tokenize(self, x: SymbolicCondition) -> SymbolicCondition:
        return x

    def forward(self, x: SymbolicCondition) -> ConditionType:
        melody = torch.as_tensor(np.asarray(x.melody, np.float32),
                                 device=self.output_proj.weight.device)
        embeds = self.output_proj(melody.transpose(1, 2))
        return embeds, _ones_mask(embeds)


class ChordsEmbConditioner(torch.nn.Module):

    def __init__(self, card: int, out_dim: int,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.card, self.out_dim = card, out_dim
        self.emb = init.embedding(card + 1, out_dim,
                                  init.normal((card + 1, out_dim), 0.02, generator))

    def tokenize(self, x: SymbolicCondition) -> SymbolicCondition:
        return x

    def forward(self, x: SymbolicCondition) -> ConditionType:
        chords = torch.as_tensor(np.asarray(x.frame_chords, np.int64),
                                 device=self.emb.weight.device)
        embeds = self.emb(chords)
        return embeds, _ones_mask(embeds)


class DrumsConditioner(torch.nn.Module):

    def __init__(self, feat_extractor: EncodecModel, out_dim: int, blurring_factor: int = 3,
                 compression_model_latent_dim: int = 128,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.__dict__['feat_extractor'] = feat_extractor   # hidden from the state dict
        self.out_dim, self.blurring_factor = out_dim, blurring_factor
        self.latent_dim = compression_model_latent_dim
        self.output_proj = _proj(compression_model_latent_dim, out_dim, generator)

    def _apply(self, fn, *args, **kwargs):
        self.feat_extractor._apply(fn, *args, **kwargs)
        return super()._apply(fn, *args, **kwargs)

    def tokenize(self, x: WavCondition,
                 stem_fn: tp.Optional[tp.Callable[[tp.Any], np.ndarray]] = None) -> WavCondition:
        """Host work: the optional drum-stem separation hook."""
        if stem_fn is not None and x.wav.shape[-1] > 1:
            x = x._replace(wav=stem_fn(x.wav))
        return x

    def _temporal_blur(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, T, C]: the mean of each span of ``blurring_factor`` frames,
        repeated over the span; the last span padded by the mirrored tail."""
        B, T, C = z.shape
        bf = self.blurring_factor
        pad = (bf - T % bf) % bf
        if pad:
            z = torch.cat([z, z[:, T - pad:].flip(1)], dim=1)
        blurred = z.reshape(B, -1, bf, C).mean(dim=2)
        return blurred.repeat_interleave(bf, dim=1)[:, :T]

    @torch.no_grad()
    def forward(self, x: WavCondition) -> ConditionType:
        device = self.output_proj.weight.device
        wav = torch.as_tensor(np.asarray(x.wav, np.float32), device=device)
        if wav.shape[-1] == 1:       # nullified
            latents = torch.zeros(wav.shape[0], 1, self.latent_dim, device=device)
        else:
            codes, _ = self.feat_extractor.encode(wav)
            latents = self.feat_extractor.decode_latent(codes[:, :1]).transpose(1, 2)
            latents = self._temporal_blur(latents)
        embeds = self.output_proj(latents)
        return embeds, _ones_mask(embeds)


class JascoConditioningProvider(ConditioningProvider):
    """Collates text, symbolic and drum conditions, the symbolic streams
    padded to ``sequence_length`` frames (reference
    jasco_conditioners.py:216-300)."""

    def __init__(self, conditioners: tp.Mapping[str, torch.nn.Module], chords_card: int = 194,
                 sequence_length: int = 500, melody_dim: int = 53):
        super().__init__(conditioners)
        self.chords_card, self.sequence_length, self.melody_dim = \
            chords_card, sequence_length, melody_dim

    @classmethod
    def from_dict(cls, conditioners: tp.Mapping[str, torch.nn.Module],
                  **kw) -> "JascoConditioningProvider":
        return cls(conditioners, **kw)

    def _pad_chords(self, chords: np.ndarray) -> np.ndarray:
        out = np.full((chords.shape[0], self.sequence_length), self.chords_card, np.int32)
        T = min(chords.shape[-1], self.sequence_length)
        out[:, :T] = chords[:, :T]
        return out

    def _pad_melody(self, melody: np.ndarray) -> np.ndarray:
        out = np.zeros((melody.shape[0], self.melody_dim, self.sequence_length), np.float32)
        T = min(melody.shape[-1], self.sequence_length)
        out[:, :, :T] = melody[:, :, :T]
        return out

    def tokenize(self, inputs: tp.Sequence[ConditioningAttributes]) -> tp.Dict[str, tp.Any]:
        """Host work: text through each text conditioner's ``tokenize``,
        chords and melody padded, wavs collated."""
        conds = self.conditioners
        out: tp.Dict[str, tp.Any] = {}
        text: tp.Dict[str, list] = {}
        wavs: tp.Dict[str, list] = {}
        chords, melodies = [], []
        for sample in inputs:
            for name in conds:
                if name in sample.text:
                    text.setdefault(name, []).append(sample.text[name])
                if name in sample.wav:
                    wavs.setdefault(name, []).append(sample.wav[name])
            for sym in sample.symbolic.values():
                if sym.frame_chords is not None:
                    chords.append(np.asarray(sym.frame_chords).reshape(1, -1))
                if sym.melody is not None:
                    melodies.append(np.asarray(sym.melody)[None])
        for name, batch in text.items():
            out[name] = conds[name].tokenize(batch)
        if chords and 'chords' in conds:
            out['chords'] = SymbolicCondition(frame_chords=self._pad_chords(np.concatenate(chords)))
        if melodies and 'melody' in conds:
            out['melody'] = SymbolicCondition(melody=self._pad_melody(np.concatenate(melodies)))
        for name, batch in wavs.items():
            out[name] = conds[name].tokenize(collate_wav_conditions(batch))
        return out
