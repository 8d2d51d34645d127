"""Spectrogram visualization (counterpart of
``audiocraft_tpu/io/spectrogram.py``; the reference's ``get_spec`` /
``save_spectrograms``, ``audio.py``:305-423).

The log-mel spectrogram's STFT runs through the port's own
``nn/chroma.stft_power`` on the wav's device (cuFFT for a tensor on the
card), its mel filterbank is the JAX package's numpy one, and the image is
drawn with matplotlib on the host.
"""

from __future__ import annotations

import typing as tp
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..nn.chroma import stft_power

Wav = tp.Union[np.ndarray, torch.Tensor]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@lru_cache(8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: tp.Optional[float] = None
                   ) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular mel filterbank (HTK-mel math)."""
    fmax = fmax or sr / 2
    mels = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    freqs = _mel_to_hz(mels)
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    fb = np.zeros((n_mels, len(fft_freqs)), np.float32)
    for i in range(n_mels):
        lo, ce, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (fft_freqs - lo) / max(ce - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ce, 1e-9)
        fb[i] = np.maximum(0, np.minimum(up, down))
    return fb


def mel_spectrogram(wav: Wav, sr: int, n_fft: int = 1024,
                    hop: int = 256, n_mels: int = 80) -> np.ndarray:
    """wav [T] or [C, T] (numpy, or a tensor on any device) -> log-mel
    [n_mels, frames] float32 on the host."""
    x = torch.as_tensor(wav).float()
    x = x.reshape(-1, x.shape[-1]).mean(0)
    power = stft_power(x[None], n_fft, n_fft, hop)[0]
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(power.device)
    mel = fb @ power
    return torch.log10(mel.clamp_min(1e-10)).cpu().numpy()


def save_spectrogram(path: tp.Union[str, Path], wav: Wav, sr: int,
                     title: str = "") -> Path:
    """Render a log-mel spectrogram image to `path` (matplotlib Agg)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    mel = mel_spectrogram(wav, sr)
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.imshow(mel, aspect='auto', origin='lower', cmap='magma')
    ax.set_title(title)
    ax.set_xlabel('frames')
    ax.set_ylabel('mel bin')
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)


def save_spectrograms(path: tp.Union[str, Path], wavs: tp.Sequence[Wav], sr: int,
                      titles: tp.Optional[tp.Sequence[str]] = None) -> Path:
    """Stacked spectrograms of several wavs (reference audio.py:368-423)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    n = len(wavs)
    titles = titles or [""] * n
    fig, axes = plt.subplots(n, 1, figsize=(8, 3 * n), squeeze=False)
    for ax, wav, title in zip(axes[:, 0], wavs, titles):
        mel = mel_spectrogram(wav, sr)
        ax.imshow(mel, aspect='auto', origin='lower', cmap='magma')
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return Path(path)
