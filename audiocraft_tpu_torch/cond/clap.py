"""CLAP embedding hooks for the joint-embedding conditioner (counterpart of
``audiocraft_tpu/cond/clap.py``).

The reference wraps ``laion_clap`` as an external frozen network; HF
``transformers`` ships the same architecture (``ClapModel``), and
:func:`make_clap_embed_fns` builds ``embed_fn`` and ``text_embed_fn`` over
one that the caller built or loaded (nothing is downloaded).  Both run on
the host in the tokenize phase and return L2-normalised embeddings and the
empty rows' indices.  ``transformers`` is imported inside the function only:
the machine with the card does not have it, and nothing on a model path
needs it.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from .attributes import JointEmbedCondition
from .joint_embed import windowed_average_embedding

CLAP_SAMPLE_RATE = 48000


def make_clap_embed_fns(model: tp.Any, tokenizer: tp.Any = None,
                        feature_extractor: tp.Any = None, max_seconds: float = 10.0,
                        stride_seconds: float = 5.0):
    """(embed_fn, text_embed_fn) over a ``transformers`` ``ClapModel``:
    audio resampled to 48 kHz mono and embedded whole, or as the mean of
    ``max_seconds`` windows every ``stride_seconds`` (reference
    conditioners.py:1179-1212); text through the text tower (needs
    ``tokenizer``).  A row of length <= 1 or an empty text is empty."""
    from transformers import ClapFeatureExtractor

    from ..io.audio_utils import convert_audio

    model.eval()
    fe = feature_extractor or ClapFeatureExtractor()
    fusion = bool(getattr(model.config.audio_config, 'enable_fusion', False))
    max_frames = int(max_seconds * CLAP_SAMPLE_RATE)
    stride = int(stride_seconds * CLAP_SAMPLE_RATE)

    def clip_embed(w: np.ndarray) -> np.ndarray:
        """[B, T] mono 48 kHz -> audio-space embeddings [B, dim]."""
        feats = fe(list(w), sampling_rate=CLAP_SAMPLE_RATE, return_tensors='pt',
                   truncation='fusion' if fusion else 'rand_trunc')
        with torch.no_grad():
            return model.get_audio_features(input_features=feats['input_features'],
                                            is_longer=feats.get('is_longer')).numpy()

    def normalize(out: np.ndarray) -> np.ndarray:
        return (out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-8)
                ).astype(np.float32)

    def embed_fn(x: JointEmbedCondition) -> tp.Tuple[np.ndarray, tp.List[int]]:
        wav = np.asarray(x.wav, np.float32)
        if wav.ndim == 3:
            wav = wav.mean(axis=1)
        empty_idx = [i for i in range(wav.shape[0]) if x.length[i] <= 1]
        embeds = []
        for i in range(wav.shape[0]):
            w = convert_audio(torch.from_numpy(wav[i:i + 1][:, None]), x.sample_rate[i],
                              CLAP_SAMPLE_RATE, 1)[:, 0].numpy()
            embeds.append(windowed_average_embedding(clip_embed, w, max_frames, stride)[0])
        return normalize(np.stack(embeds)), empty_idx

    def text_embed_fn(x: JointEmbedCondition) -> tp.Tuple[np.ndarray, tp.List[int]]:
        if tokenizer is None:
            raise ValueError("text_embed_fn needs a tokenizer for the CLAP text tower")
        texts = [t or "" for t in x.text]
        tok = tokenizer(texts, return_tensors='pt', padding=True)
        with torch.no_grad():
            emb = model.get_text_features(**tok)
        return normalize(emb.numpy()), [i for i, t in enumerate(texts) if not t]

    return embed_fn, text_embed_fn
