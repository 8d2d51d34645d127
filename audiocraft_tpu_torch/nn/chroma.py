"""Chroma features, the melody conditioning's front end
(counterpart of ``audiocraft_tpu/nn/chroma.py``).

A power spectrogram, a chroma filterbank projection, an inf-norm over the
pitch classes and, optionally, the argmax one-hot: the reference's
``modules/chroma.py`` (torchaudio's ``Spectrogram`` and librosa's chroma
filterbank), from their published math as the JAX package writes it:

* :func:`stft_power`: a periodic Hann window of ``winlen`` zero-padded to
  ``nfft`` in the middle, a reflect pad of ``nfft // 2`` at each end, frames
  times the window, ``torch.fft.rfft``, the power, divided by the sum of the
  squared window (torchaudio's ``normalized=True``).
* :func:`chroma_filterbank`: gaussian bumps in octave space wrapped to
  ``n_chroma`` pitch classes, L2-normalized per FFT bin, weighted by a
  gaussian over octaves around ``ctroct`` and rolled so that class 0 is C
  (librosa ``filters.chroma`` with ``base_c``); numpy on the host, cached.

The spectrogram and the projection run where the wav is (cuFFT on the
card).  ``torch.argmax`` takes the first maximal class, as ``jnp.argmax``
does: an all-zero wav (a nullified melody) gives all-zero chroma, whose
one-hot is class 0 at every frame.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(8)
def chroma_filterbank(sr: int, n_fft: int, n_chroma: int = 12, tuning: float = 0.0,
                      ctroct: float = 5.0, octwidth: float = 2.0,
                      base_c: bool = True) -> np.ndarray:
    """[n_chroma, 1 + n_fft // 2] float32 (librosa.filters.chroma math)."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    a440 = 440.0 * 2.0 ** (tuning / n_chroma)
    frqbins = n_chroma * np.log2(frequencies / (a440 / 16))
    frqbins = np.concatenate(([frqbins[0] - 1.5 * n_chroma], frqbins))
    binwidthbins = np.concatenate((np.maximum(frqbins[1:] - frqbins[:-1], 1.0), [1.0]))
    D = np.subtract.outer(frqbins, np.arange(0, n_chroma, dtype='d')).T
    n_chroma2 = np.round(float(n_chroma) / 2)
    D = np.remainder(D + n_chroma2 + 10 * n_chroma, n_chroma) - n_chroma2
    wts = np.exp(-0.5 * (2 * D / np.tile(binwidthbins, (n_chroma, 1))) ** 2)
    norms = np.sqrt(np.sum(wts ** 2, axis=0, keepdims=True))
    norms[norms == 0] = 1.0
    wts = wts / norms
    if octwidth is not None:
        wts *= np.tile(np.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)),
                       (n_chroma, 1))
    if base_c:
        wts = np.roll(wts, -3 * (n_chroma // 12), axis=0)
    return np.ascontiguousarray(wts[:, :int(1 + n_fft / 2)], dtype=np.float32)


def _window(winlen: int, nfft: int, device: torch.device) -> torch.Tensor:
    window = torch.from_numpy(np.hanning(winlen + 1)[:-1].astype(np.float32))
    if winlen < nfft:
        left = (nfft - winlen) // 2
        window = F.pad(window, (left, nfft - winlen - left))
    return window.to(device)


def stft_power(wav: torch.Tensor, nfft: int, winlen: int, winhop: int,
               normalized: bool = True) -> torch.Tensor:
    """[..., T] -> power spectrogram [..., 1 + nfft // 2, frames] fp32."""
    window = _window(winlen, nfft, wav.device)
    pad = nfft // 2
    shape = wav.shape[:-1]
    x = F.pad(wav.float().reshape(-1, 1, wav.shape[-1]), (pad, pad), mode='reflect')
    frames = x[:, 0].unfold(-1, nfft, winhop) * window          # [N, frames, nfft]
    power = torch.fft.rfft(frames, dim=-1).abs().square()
    if normalized:
        power = power / window.square().sum()
    return power.transpose(-1, -2).reshape(*shape, nfft // 2 + 1, -1)


@dataclasses.dataclass(frozen=True)
class ChromaExtractor:
    """wav -> chroma [B, frames, n_chroma]: the reference ``ChromaExtractor``
    with its default windows (``nfft`` = ``winlen`` = 2 ** ``radix2_exp``,
    the hop a quarter of it)."""
    sample_rate: int
    n_chroma: int = 12
    radix2_exp: int = 12
    argmax: bool = False

    @property
    def _winlen(self) -> int:
        return 2 ** self.radix2_exp

    @property
    def _nfft(self) -> int:
        return self._winlen

    @property
    def _winhop(self) -> int:
        return self._winlen // 4

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        """wav [B, C, T] or [B, T] -> chroma [B, frames, n_chroma] fp32;
        channels are averaged in the power domain, and an input shorter
        than ``nfft`` is zero-padded to it, centred (reference :50-54)."""
        T, nfft = wav.shape[-1], self._nfft
        if T < nfft:
            pad = nfft - T
            wav = F.pad(wav, (pad // 2, pad // 2 + pad % 2))
        spec = stft_power(wav, nfft, self._winlen, self._winhop)
        if spec.dim() == 4:
            spec = spec[:, 0] if spec.shape[1] == 1 else spec.mean(dim=1)
        fbanks = torch.from_numpy(chroma_filterbank(self.sample_rate, nfft,
                                                    self.n_chroma)).to(spec.device)
        raw = torch.einsum('cf,bft->bct', fbanks, spec)
        norm_chroma = raw / raw.abs().amax(dim=-2, keepdim=True).clamp_min(1e-6)
        norm_chroma = norm_chroma.transpose(-1, -2)                  # [B, frames, C]
        if self.argmax:
            idx = norm_chroma.argmax(dim=-1)
            norm_chroma = F.one_hot(idx, self.n_chroma).to(norm_chroma.dtype)
        return norm_chroma
