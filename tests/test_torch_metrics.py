"""The port's generation metrics (``metrics.py``) against the JAX package's,
on the CPU.

The distance and score math is numpy on both sides and compares within
1e-12 on the same embeddings and probabilities.  ``chroma_cosine`` runs the
port's chroma on the CPU (``device='cpu'``) against JAX's within 1e-5.  The
codec embed and prob functions run the debug codec (the port's, carried into
JAX's tree by ``test_torch_codec_train.jax_tree_from_port``) on stereo 16 kHz
clips, which both sides resample to the codec's 32 kHz mono: the embeddings
within 1e-4 of their largest value (fp32 convolutions in another order), the
histograms equal.
"""

import functools

import numpy as np
import pytest
import torch

from audiocraft_tpu import metrics as jm
from audiocraft_tpu.builders import get_debug_compression_model as jax_debug_model
from audiocraft_tpu_torch import metrics as tm
from audiocraft_tpu_torch.builders import get_debug_compression_model
from audiocraft_tpu_torch.ckpt.from_jax import encodec_state_from_jax

from test_torch_codec_train import jax_tree_from_port


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy_embed(wav, sr):
    w = wav.reshape(wav.shape[0], -1)
    return np.stack([w.mean(1), w.std(1), np.abs(w).mean(1), (w ** 2).mean(1)], axis=1)


def test_frechet_distance_and_fad_match_jax():
    rng = np.random.RandomState(0)
    mu1, mu2 = rng.randn(6), rng.randn(6)
    a, b = rng.randn(6, 6), rng.randn(6, 6)
    s1, s2 = a @ a.T + np.eye(6), b @ b.T + 0.5 * np.eye(6)
    assert tm.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(
        jm.frechet_distance(mu1, s1, mu2, s2), rel=1e-12, abs=1e-12)
    singular = np.diag([1.0, 0, 0, 0, 0, 0])
    assert tm.frechet_distance(mu1, singular, mu2, singular) == pytest.approx(
        jm.frechet_distance(mu1, singular, mu2, singular), rel=1e-12, abs=1e-12)
    ref = rng.randn(32, 1, 300).astype(np.float32)
    gen = (2.0 * rng.randn(32, 1, 300) + 0.5).astype(np.float32)
    ours, theirs = tm.FrechetAudioDistance(_toy_embed, 16000), \
        jm.FrechetAudioDistance(_toy_embed, 16000)
    for fad in (ours, theirs):
        fad.add(reference=ref[:16], generated=gen[:16])
        fad.add(reference=ref[16:], generated=gen[16:])
    assert ours.compute() == pytest.approx(theirs.compute(), rel=1e-12)
    one = tm.FrechetAudioDistance(_toy_embed, 16000)
    one.add(reference=ref[:1], generated=gen[:1])
    with pytest.raises(ValueError, match='two embeddings'):
        one.compute()


def test_kld_and_clap_score_match_jax():
    rng = np.random.RandomState(1)
    p, q = rng.rand(5, 12), rng.rand(5, 12)
    p[0, 3] = 0.0
    ours, theirs = tm.kl_divergence_metric(p, q), jm.kl_divergence_metric(p, q)
    assert set(ours) == set(theirs) == {'kld', 'kld_inverse', 'kld_symmetric'}
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k], rel=1e-12)
    t, a = rng.randn(7, 16), rng.randn(7, 16)
    assert tm.clap_score(t, a) == pytest.approx(jm.clap_score(t, a), rel=1e-12)
    with pytest.raises(ValueError, match='paired'):
        tm.clap_score(t, a[:3])


@pytest.mark.parametrize("radix2_exp", [12, 10])
def test_chroma_cosine_matches_jax(radix2_exp):
    sr = 32000
    t = np.arange(sr) / sr
    rng = np.random.RandomState(2)
    a = (np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(sr)).astype(np.float32)[None, None]
    b = (np.sin(2 * np.pi * 523.25 * t) + 0.1 * rng.randn(sr)).astype(np.float32)[None, None]
    b = np.concatenate([b, a[..., ::-1]])
    a = np.concatenate([a, a])
    ours = tm.chroma_cosine(a, b, sr, radix2_exp=radix2_exp, device='cpu')
    theirs = jm.chroma_cosine(a, b, sr, radix2_exp=radix2_exp)
    assert ours == pytest.approx(theirs, rel=1e-5)
    assert tm.chroma_cosine(a, a, sr, device='cpu') == pytest.approx(1.0, abs=1e-6)


@pytest.fixture(scope='module')
def codecs():
    port = get_debug_compression_model(32000, device='cpu')
    jmodel = jax_debug_model(32000)
    params = jax_tree_from_port(jmodel.init, port.state_dict(),
                                functools.partial(encodec_state_from_jax, port))
    wav = (np.random.RandomState(3).randn(3, 2, 16000 * 2) * 0.3).astype(np.float32)
    return port, jmodel, params, wav


@pytest.mark.parametrize("window_seconds", [1.0, 0.5])
def test_codec_embed_fn_matches_jax(codecs, window_seconds):
    port, jmodel, params, wav = codecs
    ours = tm.make_codec_embed_fn(port, window_seconds)(wav, 16000)
    theirs = jm.make_codec_embed_fn(jmodel, params, window_seconds)(wav, 16000)
    assert ours.shape == theirs.shape == (3 * int(2 / window_seconds), 64)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4 * np.abs(theirs).max())
    with pytest.raises(ValueError, match='too short'):
        tm.make_codec_embed_fn(port, 4.0)(wav, 16000)


def test_codec_prob_fn_matches_jax(codecs):
    port, jmodel, params, wav = codecs
    ours = tm.make_codec_prob_fn(port)(wav, 16000)
    theirs = jm.make_codec_prob_fn(jmodel, params)(wav, 16000)
    assert ours.shape == theirs.shape == (3, 400) and ours.dtype == np.float64
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_allclose(ours.sum(1), 1.0)
    kld = tm.kl_divergence_metric(ours, ours[::-1])
    assert kld['kld'] == pytest.approx(jm.kl_divergence_metric(theirs, theirs[::-1])['kld'])


def test_chroma_cosine_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x = np.zeros((1, 1, 4096), np.float32)
    with pytest.raises(RuntimeError, match='CUDA'):
        tm.chroma_cosine(x, x, 32000)
