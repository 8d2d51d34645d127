"""The port's audio I/O and utilities against the JAX package, on the CPU:
fades, PCM conversion, every ``normalize_audio`` strategy (BS.1770
loudness too), WAV read and write, and HPSS.

Inputs are made from a seed with numpy.  Fades and normalized audio
compare at 1e-5 relative; the loudness (the JAX package filters in fp32
by ``lax.scan``, the port in float64 by ``scipy.signal.lfilter``) within
1e-3 dB; PCM and HPSS (both numpy) exactly or at float rounding.
"""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocraft_tpu.io import audio_utils as jax_audio_utils
from audiocraft_tpu.io import hpss as jax_hpss
from audiocraft_tpu.io import wav as jax_wav
from audiocraft_tpu_torch.io import audio_utils, hpss, wav

SR = 32000


def _audio(shape, seed, scale=0.3):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", ['linear', 'exponential', 'logarithmic', 'quarter_sine',
                                   'half_sine'])
@pytest.mark.parametrize("out,start", [(True, True), (False, False), (True, False)])
def test_tafade_matches_jax(shape, out, start):
    x = _audio((2, 1, 3000), seed=1)
    ref = np.asarray(jax_audio_utils.apply_tafade(jnp.asarray(x), 1000, duration=1.5, out=out,
                                                  start=start, shape=shape))
    got = audio_utils.apply_tafade(torch.from_numpy(x), 1000, duration=1.5, out=out,
                                   start=start, shape=shape)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_fade_and_refusals_match_jax():
    x = _audio((1, 2, 2000), seed=2)
    for kw in (dict(out=True, start=True), dict(out=False, start=False, curve_start=0.2,
                                                curve_end=0.9), dict(duration=5.0)):
        ref = np.asarray(jax_audio_utils.apply_fade(jnp.asarray(x), 1000, **kw))
        got = audio_utils.apply_fade(torch.from_numpy(x), 1000, **kw)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        audio_utils.apply_tafade(torch.from_numpy(x), 1000, shape='cubic')


def test_pcm_conversion_matches_jax():
    f = np.concatenate([_audio((1, 1000), seed=3, scale=0.6), [[1.2, -1.3, 1.0, -1.0]]],
                       axis=1).astype(np.float32)
    np.testing.assert_array_equal(audio_utils.i16_pcm(f), jax_audio_utils.i16_pcm(f))
    for pcm in (audio_utils.i16_pcm(f), (np.clip(f, -1, 1) * 2 ** 30).astype(np.int32)):
        np.testing.assert_array_equal(audio_utils.f32_pcm(pcm), jax_audio_utils.f32_pcm(pcm))
    np.testing.assert_array_equal(audio_utils.f32_pcm(f.astype(np.float64)), f)
    with pytest.raises(ValueError):
        audio_utils.f32_pcm(np.zeros(3, np.uint8))


@pytest.mark.parametrize("strategy", ['peak', 'clip', 'rms', 'loudness', 'none', None])
@pytest.mark.parametrize("normalize", [True, False])
def test_normalize_audio_matches_jax(strategy, normalize):
    x = _audio((2, 16000), seed=4, scale=0.8)
    kw = dict(normalize=normalize, strategy=strategy, sample_rate=SR)
    ref = np.asarray(jax_audio_utils.normalize_audio(jnp.asarray(x), **kw))
    got = audio_utils.normalize_audio(torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        audio_utils.normalize_audio(torch.from_numpy(x), strategy='median')


@pytest.mark.parametrize("sr", [32000, 44100])
def test_loudness_matches_jax(sr):
    x = _audio((2, sr), seed=5, scale=0.2)
    ref_db = float(jax_audio_utils._bs1770_loudness(jnp.asarray(x), sr))
    got_db = audio_utils._bs1770_loudness(torch.from_numpy(x), sr)
    assert abs(got_db - ref_db) < 1e-3
    for compressor in (False, True):
        ref = np.asarray(jax_audio_utils.normalize_loudness(jnp.asarray(x), sr,
                                                            loudness_compressor=compressor))
        got = audio_utils.normalize_loudness(torch.from_numpy(x), sr,
                                             loudness_compressor=compressor)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)
    quiet = x * 1e-3   # under the energy floor: returned as it was
    np.testing.assert_array_equal(audio_utils.normalize_loudness(torch.from_numpy(quiet), sr).numpy(),
                                  quiet)
    for (b, a), (jb, ja) in zip(audio_utils._kweighting_coeffs(sr),
                                jax_audio_utils._kweighting_coeffs(sr)):
        np.testing.assert_allclose(b, jb, rtol=1e-12)
        np.testing.assert_allclose(a, ja, rtol=1e-12)


def test_wav_round_trip_and_jax_reads_it(tmp_path):
    x = np.clip(_audio((2, 4000), seed=6, scale=0.5), -0.99, 0.99)
    path = tmp_path / 'a.wav'
    wav.wav_write(x, path, SR)
    got, sr = wav.wav_read(path)
    assert sr == SR and got.shape == x.shape
    np.testing.assert_allclose(got, x, atol=1.0 / 2 ** 15)
    ref, _ = jax_wav.wav_read(path)
    np.testing.assert_array_equal(got, ref)
    wav.wav_write(x, tmp_path / 'f.wav', SR, dtype='float32')
    np.testing.assert_array_equal(wav.wav_read(tmp_path / 'f.wav')[0], x)
    part, _ = wav.wav_read(path, seek_time=0.025, duration=0.05)
    np.testing.assert_array_equal(part, got[:, 800:2400])
    assert wav.audio_info(path) == jax_wav.audio_info(path) == (SR, 4000 / SR, 2)
    padded, _ = wav.audio_read(path, duration=0.2, pad=True)
    assert padded.shape == (2, 6400) and not padded[:, 4000:].any()
    # 24-bit PCM, as the JAX reader reads it
    pcm = (x.T.reshape(-1) * 2 ** 23).astype(np.int32)
    raw = np.stack([pcm & 0xff, (pcm >> 8) & 0xff, (pcm >> 16) & 0xff], 1).astype(np.uint8)
    data = raw.tobytes()
    header = (b'RIFF' + struct.pack('<I', 36 + len(data)) + b'WAVE' + b'fmt '
              + struct.pack('<IHHIIHH', 16, 1, 2, SR, SR * 6, 6, 24)
              + b'data' + struct.pack('<I', len(data)))
    (tmp_path / 'p24.wav').write_bytes(header + data)
    np.testing.assert_array_equal(wav.wav_read(tmp_path / 'p24.wav')[0],
                                  jax_wav.wav_read(tmp_path / 'p24.wav')[0])
    for bad in (tmp_path / 'a.mp3', tmp_path / 'b.flac'):
        with pytest.raises(ValueError, match='only WAV'):
            wav.audio_read(bad)


@pytest.mark.parametrize("strategy", ['peak', 'loudness'])
def test_audio_write_matches_jax(tmp_path, strategy):
    x = _audio((1, 8000), seed=7, scale=0.4)
    ours = wav.audio_write(tmp_path / 'ours', torch.from_numpy(x[0]), SR, strategy=strategy)
    theirs = jax_wav.audio_write(tmp_path / 'theirs', x, SR, strategy=strategy)
    assert ours.name == 'ours.wav' and theirs.name == 'theirs.wav'
    a, b = wav.audio_read(ours)[0], wav.audio_read(theirs)[0]
    assert np.abs(a - b).max() <= 1.0 / 2 ** 15   # at most one PCM step apart
    with pytest.raises(ValueError):
        wav.audio_write(tmp_path / 'x', x, SR, format='mp3')


def test_harmonic_matches_jax():
    t = np.arange(SR) / SR
    tone = 0.3 * np.sin(2 * np.pi * 440 * t)
    clicks = np.zeros_like(tone)
    clicks[::4000] = 1.0
    x = np.stack([tone + clicks, tone]).astype(np.float32)
    h, p = hpss.hpss(x)
    jh, jp = jax_hpss.hpss(x)
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(hpss.harmonic(x), jh)
    assert np.abs(h[0] - tone).max() < np.abs(x[0] - tone).max()
