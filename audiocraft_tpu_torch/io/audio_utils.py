"""Audio utility ops: channel conversion, resampling, normalization, PCM
conversion and fades (counterpart of ``audiocraft_tpu/io/audio_utils.py``).

* ``convert_audio_channels`` and ``convert_audio``: mono downmix, channel
  duplication, julius-math resampling.
* ``normalize_loudness``: ITU-R BS.1770 loudness with the K-weighting
  biquads (``_kweighting_coeffs``).  The JAX package runs each biquad as a
  ``lax.scan`` over the samples in fp32; here the two filters run as one
  direct-form IIR each on the host (``scipy.signal.lfilter``, float64), and
  only the loudness, a scalar, goes back to the tensor's device.
* ``normalize_audio``: the peak, clip, rms and loudness strategies.
* ``f32_pcm`` and ``i16_pcm``: numpy PCM conversion.
* ``apply_tafade`` and ``apply_fade``: the fork's fades, which the segment
  stitch of ``gen/extend.py`` uses.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from scipy.signal import lfilter

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


# ------------------------------------------------------------- loudness

def _kweighting_coeffs(sr: int) -> tp.Tuple[tp.Tuple[np.ndarray, np.ndarray],
                                             tp.Tuple[np.ndarray, np.ndarray]]:
    """The high-shelf and RLB high-pass biquads of ITU-R BS.1770-4 at ``sr``:
    ((b, a) shelf, (b, a) high-pass)."""
    f0, gain, q = 1681.974450955533, 3.999843853973347, 0.7071752369554196
    k = np.tan(np.pi * f0 / sr)
    vh = 10 ** (gain / 20.0)
    vb = vh ** 0.4996667741545416
    denom = 1 + k / q + k * k
    b_shelf = np.array([(vh + vb * k / q + k * k) / denom, 2 * (k * k - vh) / denom,
                        (vh - vb * k / q + k * k) / denom])
    a_shelf = np.array([1.0, 2 * (k * k - 1) / denom, (1 - k / q + k * k) / denom])
    f0, q = 38.13547087602444, 0.5003270373238773
    k = np.tan(np.pi * f0 / sr)
    denom = 1 + k / q + k * k
    # the numerator scaled by 1 / denom, as the JAX package's coefficients are
    b_hp = np.array([1.0, -2.0, 1.0]) / denom
    a_hp = np.array([1.0, 2 * (k * k - 1) / denom, (1 - k / q + k * k) / denom])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def _bs1770_loudness(wav: torch.Tensor, sr: int) -> float:
    """Loudness in dB of the whole tensor (every channel and item): the two
    K-weighting biquads along the last axis, then ``-0.691 + 10 log10`` of
    the mean power."""
    (bs, as_), (bh, ah) = _kweighting_coeffs(sr)
    x = wav.detach().to('cpu', torch.float64).numpy()
    y = lfilter(bh, ah, lfilter(bs, as_, x, axis=-1), axis=-1)
    return -0.691 + 10 * math.log10(float(np.mean(np.square(y))) + 1e-12)


def normalize_loudness(wav: torch.Tensor, sample_rate: int, loudness_headroom_db: float = 14.0,
                       loudness_compressor: bool = False,
                       energy_floor: float = 2e-3) -> torch.Tensor:
    """Scale to ``-loudness_headroom_db`` of BS.1770 loudness (reference
    ``audio_utils.py``:58-89); a signal whose rms is under ``energy_floor``
    comes back as it was; ``loudness_compressor`` applies tanh."""
    energy = float(wav.float().square().mean().sqrt())
    if energy < energy_floor:
        return wav
    volume = 10 ** ((-loudness_headroom_db - _bs1770_loudness(wav, sample_rate)) / 20)
    out = wav * volume
    return torch.tanh(out) if loudness_compressor else out


def normalize_audio(wav: torch.Tensor, normalize: bool = True, strategy: tp.Optional[str] = 'peak',
                    peak_clip_headroom_db: float = 1.0, rms_headroom_db: float = 18.0,
                    loudness_headroom_db: float = 14.0, loudness_compressor: bool = False,
                    sample_rate: tp.Optional[int] = None) -> torch.Tensor:
    """Normalize by ``strategy``: 'peak', 'clip', 'rms', 'loudness', or
    ''/'none'/None (reference ``audio_utils.py``:92-146)."""
    scale_peak = 10 ** (-peak_clip_headroom_db / 20)
    scale_rms = 10 ** (-rms_headroom_db / 20)
    if strategy == 'peak':
        if normalize:
            wav = wav * (scale_peak / wav.abs().max().clamp_min(1e-12))
    elif strategy == 'clip':
        wav = wav.clamp(-scale_peak, scale_peak)
    elif strategy == 'rms':
        mono = wav.mean(dim=0, keepdim=True) if wav.dim() > 1 else wav
        if normalize:
            wav = wav * (scale_rms / mono.square().mean().sqrt().clamp_min(1e-12))
        wav = wav.clamp(-1.0, 1.0)
    elif strategy == 'loudness':
        if sample_rate is None:
            raise ValueError("the loudness strategy needs the sample_rate")
        wav = normalize_loudness(wav, sample_rate, loudness_headroom_db, loudness_compressor)
        wav = wav.clamp(-1.0, 1.0)
    elif strategy not in ('', 'none', None):
        raise ValueError(f"unknown strategy {strategy}")
    return wav


# ------------------------------------------------------------------ PCM

def f32_pcm(wav: np.ndarray) -> np.ndarray:
    """float32 in [-1, 1) from float, int16 or int32 PCM."""
    if wav.dtype.kind == 'f':
        return wav.astype(np.float32)
    if wav.dtype not in (np.int16, np.int32):
        raise ValueError(f"PCM of dtype {wav.dtype}: int16 or int32")
    bits = 15 if wav.dtype == np.int16 else 31
    return wav.astype(np.float32) / (2 ** bits)


def i16_pcm(wav: np.ndarray) -> np.ndarray:
    """int16 PCM from float (clipped) or integer samples."""
    if wav.dtype.kind == 'i':
        return wav.astype(np.int16)
    if wav.dtype.kind != 'f':
        raise ValueError(f"PCM of dtype {wav.dtype}: float or integer")
    return np.clip(wav * (2 ** 15), -2 ** 15, 2 ** 15 - 1).astype(np.int16)


# ---------------------------------------------------------------- fades

def _apply_ramp(audio: torch.Tensor, curve: torch.Tensor, out: bool,
                start: bool) -> torch.Tensor:
    """``audio`` times a ramp of ones with ``curve`` (reversed for a fade
    out) over its first (``start``) or last samples."""
    if out:
        curve = curve.flip(0)
    length, n = audio.shape[-1], curve.shape[0]
    ramp = torch.ones(length, device=audio.device)
    if start:
        ramp[:n] = curve
    else:
        ramp[length - n:] = curve
    return audio * ramp


def apply_tafade(audio: torch.Tensor, sample_rate: int, duration: float = 3.0, out: bool = True,
                 start: bool = True, shape: str = 'linear') -> torch.Tensor:
    """A fade of ``duration`` seconds with a torchaudio ``Fade`` shape
    (reference ``audio_utils.py``:179-240)."""
    n = min(int(sample_rate * duration), audio.shape[-1])
    t = torch.linspace(0.0, 1.0, n, device=audio.device)
    if shape == 'linear':
        curve = t
    elif shape == 'exponential':
        curve = torch.pow(2.0, t - 1) * t
    elif shape == 'logarithmic':
        curve = t.sqrt()
    elif shape == 'quarter_sine':
        curve = torch.sin(t * math.pi / 2)
    elif shape == 'half_sine':
        curve = torch.sin(t * math.pi - math.pi / 2) / 2 + 0.5
    else:
        raise ValueError(f"unknown fade shape {shape}")
    return _apply_ramp(audio, curve, out, start)


def apply_fade(audio: torch.Tensor, sample_rate: int, duration: float = 3.0, out: bool = True,
               start: bool = True, curve_start: float = 0.0,
               curve_end: float = 1.0) -> torch.Tensor:
    """A linear fade between two gains (reference ``audio_utils.py``:243-296);
    the ramp is made where ``audio`` is."""
    n = min(int(sample_rate * duration), audio.shape[-1])
    curve = torch.linspace(curve_start, curve_end, n, device=audio.device)
    return _apply_ramp(audio, curve, out, start)
