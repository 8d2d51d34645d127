"""Conditioners: embed conditioning attributes into (tensor, mask) pairs
(counterpart of ``audiocraft_tpu/cond/conditioners.py``).

Each conditioner keeps the reference's two phases: ``tokenize()`` is host
work (string processing, tokenizer calls) that returns CPU tensors;
``forward(tokenized)`` embeds on the conditioner's device.  Parameter names
follow the reference state dict under ``condition_provider``:
``conditioners.<name>.output_proj.{weight,bias}`` and, for the lookup-table
conditioner, ``conditioners.<name>.embed.weight``.  The T5 conditioner also
holds its encoder under ``conditioners.<name>.t5.`` with HF T5 names (the
reference hides it from the state dict; published T5 weights arrive
separately).

Wav conditions (the melody's chroma, ``cond/chroma_cond.py``, and the
style's excerpt, ``cond/style_cond.py``) are collated across the batch by
:func:`collate_wav_conditions`, zero-padded to the longest, and handed to
their conditioner's ``tokenize``.  The joint-embedding (CLAP) conditioner
is ``cond/joint_embed.py``, JASCO's provider ``cond/jasco_conditioners.py``.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from ..nn import init
from ..nn.t5 import T5Encoder, T5EncoderConfig
from .attributes import ConditioningAttributes, WavCondition
from .tokenizers import NoopTokenizer, WhiteSpaceTokenizer

ConditionType = tp.Tuple[torch.Tensor, torch.Tensor]
Tokenized = tp.Tuple[torch.Tensor, torch.Tensor]  # (ids [B, T], mask [B, T]) on the CPU


def _embed_output(module: torch.nn.Module, embeds: torch.Tensor,
                  mask: torch.Tensor) -> ConditionType:
    embeds = module.output_proj(embeds)
    return embeds * mask[..., None].to(embeds.dtype), mask


class LUTConditioner(torch.nn.Module):
    """Lookup-table text conditioner over hashed words."""

    def __init__(self, n_bins: int, dim: int, output_dim: int, tokenizer: str = 'whitespace',
                 pad_idx: int = 0, generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        if tokenizer not in ('whitespace', 'noop'):
            raise ValueError(f"unrecognized tokenizer `{tokenizer}`")
        self.n_bins, self.dim, self.output_dim = n_bins, dim, output_dim
        self.tokenizer, self.pad_idx = tokenizer, pad_idx
        self.embed = init.embedding(n_bins, dim, init.normal((n_bins, dim), 1.0, generator))
        bound = 1.0 / math.sqrt(dim)
        self.output_proj = init.linear(dim, output_dim, True, bound, generator, bias_bound=bound)

    def tokenize(self, x: tp.List[tp.Optional[str]]) -> Tokenized:
        cls = WhiteSpaceTokenizer if self.tokenizer == 'whitespace' else NoopTokenizer
        tokens, mask = cls(self.n_bins, pad_idx=self.pad_idx)(x)
        return torch.from_numpy(np.asarray(tokens)), torch.from_numpy(np.asarray(mask))

    def forward(self, inputs: Tokenized) -> ConditionType:
        device = self.embed.weight.device
        tokens, mask = (t.to(device) for t in inputs)
        return _embed_output(self, self.embed(tokens.long()), mask)


class T5Conditioner(torch.nn.Module):
    """T5-encoder text conditioner.  ``tokenize`` needs an HF-style tokenizer
    (a callable returning ``input_ids`` and ``attention_mask`` arrays).
    ``config`` (None: the architecture of ``name``) is the encoder's shape;
    ``finetune`` and ``word_dropout``, which the JAX package reads nowhere,
    are kept for the checkpoint config only."""

    MODELS_DIMS = {"t5-small": 512, "t5-base": 768, "t5-large": 1024, "t5-3b": 1024,
                   "t5-11b": 1024, "google/flan-t5-small": 512, "google/flan-t5-base": 768,
                   "google/flan-t5-large": 1024}

    def __init__(self, name: str = 't5-base', output_dim: int = 512,
                 config: tp.Optional[T5EncoderConfig] = None, finetune: bool = False,
                 word_dropout: float = 0.0, generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.name, self.config = name, config
        self.finetune, self.word_dropout = finetune, word_dropout
        self.t5_config = config or T5EncoderConfig.for_name(name)
        self.dim = self.t5_config.d_model
        self.output_dim = output_dim
        self.t5 = T5Encoder(self.t5_config, generator)
        self.output_proj = init.linear(self.dim, output_dim, True, 1.0 / math.sqrt(self.dim),
                                       generator)

    def load_tokenizer(self):
        raise RuntimeError(
            f"the {self.name!r} tokenizer vocabulary (its SentencePiece model) is not in this "
            f"repository, and the port does not download it; pass tokenizer= to tokenize(), "
            f"or feed T5 token ids to the conditioner directly")

    def tokenize(self, x: tp.List[tp.Optional[str]], tokenizer=None) -> Tokenized:
        entries = [xi if xi is not None else "" for xi in x]
        tokenizer = tokenizer or self.load_tokenizer()
        enc = tokenizer(entries, return_tensors='np', padding=True)
        ids = np.asarray(enc['input_ids'])
        mask = np.array(enc['attention_mask'])
        mask[[i for i, xi in enumerate(entries) if xi == ""], :] = 0
        return torch.from_numpy(ids), torch.from_numpy(mask)

    def forward(self, inputs: Tokenized) -> ConditionType:
        device = self.output_proj.weight.device
        ids, mask = (t.to(device) for t in inputs)
        return _embed_output(self, self.t5(ids.long(), mask), mask)


def collate_wav_conditions(conds: tp.Sequence[WavCondition]) -> WavCondition:
    """One batch of per-sample wav conditions: the wavs zero-padded to the
    longest and stacked, the lengths, rates, paths and seek times joined
    (reference ``ConditioningProvider._collate_wavs``,
    ``conditioners.py``:1547-1600)."""
    wavs = [np.asarray(c.wav) for c in conds]
    max_t = max(w.shape[-1] for w in wavs)
    padded = np.concatenate([np.pad(w, ((0, 0),) * (w.ndim - 1) + ((0, max_t - w.shape[-1]),))
                             for w in wavs], axis=0)
    lengths = np.concatenate([np.asarray(c.length).reshape(-1) for c in conds])
    return WavCondition(padded, lengths, sum((list(c.sample_rate) for c in conds), []),
                        sum((list(c.path) for c in conds), []),
                        sum((list(c.seek_time) for c in conds), []))


class ConditioningProvider(torch.nn.Module):
    """Named conditioners with collated tokenize and forward phases;
    ``conditioners`` is a mapping or, as the JAX package keeps it, a
    sequence of (name, conditioner) pairs."""

    def __init__(self, conditioners: tp.Union[tp.Mapping[str, torch.nn.Module],
                                              tp.Sequence[tp.Tuple[str, torch.nn.Module]]]):
        super().__init__()
        self.conditioners = torch.nn.ModuleDict(conditioners)

    @classmethod
    def from_dict(cls, conditioners: tp.Mapping[str, torch.nn.Module]) -> "ConditioningProvider":
        return cls(conditioners)

    def tokenize(self, inputs: tp.Sequence[ConditioningAttributes]
                 ) -> tp.Dict[str, tp.Union[Tokenized, WavCondition]]:
        """Collate each text and wav attribute across the batch and tokenize
        it (host work)."""
        text: tp.Dict[str, tp.List[tp.Optional[str]]] = {}
        wavs: tp.Dict[str, tp.List[WavCondition]] = {}
        for sample in inputs:
            for name in self.conditioners:
                if name in sample.text:
                    text.setdefault(name, []).append(sample.text[name])
                if name in sample.wav:
                    wavs.setdefault(name, []).append(sample.wav[name])
        out: tp.Dict[str, tp.Union[Tokenized, WavCondition]] = {
            name: self.conditioners[name].tokenize(batch) for name, batch in text.items()}
        for name, batch in wavs.items():
            out[name] = self.conditioners[name].tokenize(collate_wav_conditions(batch))
        return out

    def forward(self, tokenized: tp.Mapping[str, tp.Any]) -> tp.Dict[str, ConditionType]:
        return {name: self.conditioners[name](inputs) for name, inputs in tokenized.items()}
