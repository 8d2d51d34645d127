"""Harmonic/percussive source separation by median filtering (a copy of
``audiocraft_tpu/io/hpss.py``, numpy and scipy only, which the port may not
import).

The reference's ``harmony_only`` melody preprocessing calls
``librosa.effects.hpss`` (reference ``utils/extend.py``:216-227) to strip
percussion before conditioning.  This is the same published algorithm
(Fitzgerald 2010 median-filter HPSS with soft Wiener masks, librosa's
defaults: n_fft 2048, hop 512, kernel 31, power 2) on numpy and scipy, on
the host.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import median_filter


def _stft(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    window = np.hanning(n_fft + 1)[:-1]
    pad = n_fft // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode='reflect')
    n_frames = 1 + (xp.shape[-1] - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = xp[..., idx] * window
    return np.swapaxes(np.fft.rfft(frames, axis=-1), -1, -2)


def _istft(z: np.ndarray, n_fft: int, hop: int, length: int) -> np.ndarray:
    window = np.hanning(n_fft + 1)[:-1]
    frames = np.fft.irfft(np.swapaxes(z, -1, -2), n=n_fft, axis=-1) * window
    n_frames = frames.shape[-2]
    total = hop * (n_frames - 1) + n_fft
    out = np.zeros(z.shape[:-2] + (total,), np.float64)
    wsum = np.zeros(total)
    for t in range(n_frames):
        out[..., t * hop:t * hop + n_fft] += frames[..., t, :]
        wsum[t * hop:t * hop + n_fft] += window ** 2
    out = out / np.maximum(wsum, 1e-10)
    pad = n_fft // 2
    return out[..., pad:pad + length].astype(np.float32)


def hpss(wav: np.ndarray, n_fft: int = 2048, hop: int = 512,
         kernel_size: int = 31, power: float = 2.0
         ) -> tuple:
    """[..., T] -> (harmonic, percussive) waveforms (librosa.effects.hpss
    semantics: median filter the magnitude spectrogram along time for the
    harmonic estimate and along frequency for the percussive one, then apply
    soft masks to the complex STFT)."""
    wav = np.asarray(wav, np.float32)
    z = _stft(wav, n_fft, hop)                    # [..., F, T']
    mag = np.abs(z)
    harm = median_filter(mag, size=(1,) * (mag.ndim - 2) + (1, kernel_size),
                         mode='reflect')
    perc = median_filter(mag, size=(1,) * (mag.ndim - 2) + (kernel_size, 1),
                         mode='reflect')
    hp = harm ** power
    pp = perc ** power
    total = hp + pp
    total[total < 1e-10] = 1e-10
    mask_h = hp / total
    mask_p = pp / total
    T = wav.shape[-1]
    return (_istft(z * mask_h, n_fft, hop, T),
            _istft(z * mask_p, n_fft, hop, T))


def harmonic(wav: np.ndarray, **kw) -> np.ndarray:
    """Harmonic component only (the `harmony_only` melody filter)."""
    return hpss(wav, **kw)[0]
