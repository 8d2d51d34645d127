"""Channel conversion and resampling of audio
(counterpart of ``audiocraft_tpu/io/audio_utils.py``: ``convert_audio_channels``
and ``convert_audio`` only, what ``MusicGen.generate_continuation`` needs).
"""

from __future__ import annotations

import torch

from .resample import resample_frac


def convert_audio_channels(wav: torch.Tensor, channels: int = 2) -> torch.Tensor:
    """[..., C, T] -> [..., channels, T]: mono by the mean, duplicated mono,
    or the first channels (reference ``audio_utils.py``:16-46)."""
    *shape, src_channels, length = wav.shape
    if src_channels == channels:
        return wav
    if channels == 1:
        return wav.mean(dim=-2, keepdim=True)
    if src_channels == 1:
        return wav.expand(*shape, channels, length)
    if src_channels >= channels:
        return wav[..., :channels, :]
    raise ValueError('The audio file has less channels than requested but is not mono.')


def convert_audio(wav: torch.Tensor, from_rate: int, to_rate: int,
                  to_channels: int) -> torch.Tensor:
    """Resample (julius math), then convert the channels."""
    wav = resample_frac(wav, int(from_rate), int(to_rate))
    return convert_audio_channels(wav, to_channels)
