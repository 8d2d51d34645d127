"""The port's MusicGen facade, chunked codec and audio conversion against
the JAX package, on the CPU.

The JAX debug MusicGen's weights reach the port's through
``ckpt/from_jax.load_musicgen_from_jax``.  Greedy tokens compare exactly
(both sides decode in fp32 on the CPU); audio and resampling at 1e-5 (fp32
convolutions, only the order of the sums differs); chunked decode against
the whole decode at 1e-5 (the windows sum in other blocks), chunked encode
codes exactly.  The CPU's transposed convolutions are slow with many threads
at the debug codec's lengths, so the module runs torch on one thread.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.builders import get_debug_compression_model as jax_debug_codec
from audiocraft_tpu.codec import chunked as jax_chunked
from audiocraft_tpu.cond.conditioners import ConditioningProvider as JaxProvider
from audiocraft_tpu.cond.conditioners import LUTConditioner as JaxLUT
from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
from audiocraft_tpu.gen.musicgen import MusicGen as JaxMusicGen
from audiocraft_tpu.io import audio_utils as jax_audio_utils
from audiocraft_tpu.io import resample as jax_resample
from audiocraft_tpu.lm.model import LMModel as JaxLM
from audiocraft_tpu.patterns import DelayedPatternProvider as JaxDelayed
from audiocraft_tpu_torch.ckpt.from_jax import load_musicgen_from_jax
from audiocraft_tpu_torch.codec import chunked
from audiocraft_tpu_torch.cond.attributes import (ConditioningAttributes, WavCondition,
                                                  drop_description_condition)
from audiocraft_tpu_torch.gen.musicgen import get_debug_musicgen
from audiocraft_tpu_torch.io import audio_utils, resample
from audiocraft_tpu_torch.nn.transformer import QuantizedWeight

DESCRIPTIONS = ['a short jingle', 'calm piano at night']


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def pair():
    """The JAX package's debug MusicGen (its ``get_debug_musicgen`` with the
    inits under ``jit``, which is faster on the CPU) and the port's, holding
    the same weights."""
    codec = jax_debug_codec(32000)
    lm = JaxLM(pattern_provider=JaxDelayed(4), fuser=JaxFuser.from_dict({'cross': (
        'description',)}), n_q=4, card=400, dim=16, num_heads=4, num_layers=2,
        cross_attention=True, causal=True, norm_first=False, activation='relu')
    provider = JaxProvider.from_dict({'description': JaxLUT(
        n_bins=128, dim=16, output_dim=16, tokenizer='whitespace')})
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    jmg = JaxMusicGen(name='debug', compression_model=codec,
                      codec_params=jax.jit(codec.init)(k1), lm=lm,
                      lm_params=jax.jit(lm.init)(k2), condition_provider=provider,
                      cond_params=provider.init(k3), max_duration=30.0, duration=5.0)
    tmg = get_debug_musicgen(device='cpu')
    load_musicgen_from_jax(tmg, _np_tree(jmg.codec_params), _np_tree(jmg.lm_params),
                           _np_tree(jmg.cond_params))
    return jmg, tmg


def _set_both(jmg, tmg, **kw):
    for mg in (jmg, tmg):
        mg.set_generation_params(**kw)


# ------------------------------------------------------------------- audio
@pytest.mark.parametrize("from_rate,to_rate,channels", [
    (44100, 32000, 1), (16000, 32000, 1), (48000, 32000, 2), (32000, 32000, 1)])
def test_convert_audio_equals_jax(from_rate, to_rate, channels):
    x = np.random.RandomState(0).randn(2, 2, 3001).astype(np.float32)
    ref = np.asarray(jax_audio_utils.convert_audio(jnp.asarray(x), from_rate, to_rate, channels))
    out = audio_utils.convert_audio(torch.from_numpy(x), from_rate, to_rate, channels)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_resample_frac_and_channels_equal_jax():
    x = np.random.RandomState(1).randn(3, 777).astype(np.float32)
    ref = np.asarray(jax_resample.resample_frac(jnp.asarray(x), 22050, 32000))
    np.testing.assert_allclose(resample.resample_frac(torch.from_numpy(x), 22050, 32000).numpy(),
                               ref, rtol=1e-5, atol=1e-5)
    mono = np.random.RandomState(2).randn(2, 1, 50).astype(np.float32)
    for src, channels in ((mono, 2), (x[None], 2), (x[None], 1)):   # the mean: 1e-6
        np.testing.assert_allclose(
            audio_utils.convert_audio_channels(torch.from_numpy(src), channels).numpy(),
            np.asarray(jax_audio_utils.convert_audio_channels(jnp.asarray(src), channels)),
            rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        audio_utils.convert_audio_channels(torch.from_numpy(x[None, :2]), 3)


# ----------------------------------------------------------------- chunked
def test_chunked_decode_and_encode_equal_jax(pair):
    jmg, tmg = pair
    codec, params = jmg.compression_model, jax.tree.map(jnp.asarray, jmg.codec_params)
    codes = np.random.RandomState(4).randint(0, 400, (2, 4, 130)).astype(np.int64)
    ref = np.asarray(jax_chunked.chunked_decode(codec, params, jnp.asarray(codes),
                                                chunk_frames=40))
    out = chunked.chunked_decode(tmg.compression_model, torch.from_numpy(codes),
                                 chunk_frames=40)
    whole = tmg.compression_model.decode(torch.from_numpy(codes))
    assert out.shape == ref.shape == whole.shape == (2, 1, 130 * 1280)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    x = np.random.RandomState(5).randn(2, 1, 130 * 1280 + 77).astype(np.float32) * 0.3
    ref_codes, _ = jax_chunked.chunked_encode(codec, params, jnp.asarray(x), chunk_frames=40)
    codes, scale = chunked.chunked_encode(tmg.compression_model, torch.from_numpy(x),
                                          chunk_frames=40)
    assert scale is None and codes.shape == (2, 4, 131)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    padded = torch.nn.functional.pad(torch.from_numpy(x), (0, 131 * 1280 - x.shape[-1]))
    np.testing.assert_array_equal(codes.numpy(),
                                  tmg.compression_model.encode(padded)[0].numpy())


# ------------------------------------------------------------------ facade
@pytest.mark.parametrize("two_step", [False, True])
def test_facade_greedy_tokens_and_audio_equal_jax(pair, two_step):
    jmg, tmg = pair
    _set_both(jmg, tmg, use_sampling=False, duration=2.0, two_step_cfg=two_step)
    ref_audio, ref = jmg.generate(DESCRIPTIONS, jax.random.PRNGKey(0), return_tokens=True)
    audio, tokens = tmg.generate(DESCRIPTIONS, return_tokens=True)
    assert tokens.shape == (2, 4, 50) and ((tokens >= 0) & (tokens < 400)).all()
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    assert audio.shape == (2, 1, 50 * 1280)
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), rtol=1e-5, atol=1e-5)


def test_stride_extension_equals_jax_in_two_windows(pair):
    jmg, tmg = pair
    for mg in (jmg, tmg):
        mg.max_duration = 2.0
    try:
        _set_both(jmg, tmg, use_sampling=False, duration=3.0, extend_stride=1.0)
        windows = []
        tmg.set_custom_progress_callback(lambda done, text: windows.append(done))
        ref = np.asarray(jmg.generate(DESCRIPTIONS, jax.random.PRNGKey(0), return_tokens=True)[1])
        audio, tokens = tmg.generate(DESCRIPTIONS, return_tokens=True)
    finally:
        tmg.set_custom_progress_callback(None)
        for mg in (jmg, tmg):
            mg.max_duration = 30.0
    assert windows == [50 / 75, 1.0]
    assert tokens.shape == (2, 4, 75) and audio.shape == (2, 1, 75 * 1280)
    np.testing.assert_array_equal(tokens.numpy(), ref)


def test_serving_recipe_tokens_equal_jax(pair):
    """int8 weights, int8 KV caches and 'auto' buckets on both sides (fp32
    compute on the CPU), on copies."""
    jmg, tmg = dataclasses.replace(pair[0]), copy.deepcopy(pair[1])
    for mg in (jmg, tmg):
        mg.optimize_for_serving()
    assert tmg.kv_dtype == 'int8' and tmg.kv_buckets == 'auto'
    assert isinstance(tmg.lm.linears[0].weight, QuantizedWeight)
    _set_both(jmg, tmg, use_sampling=False, duration=2.0)
    ref = np.asarray(jmg.generate(DESCRIPTIONS, jax.random.PRNGKey(0), return_tokens=True)[1])
    tokens = tmg.generate(DESCRIPTIONS, return_tokens=True)[1]
    np.testing.assert_array_equal(tokens.numpy(), ref)



def test_facade_reads_weights_loaded_after_a_generate(pair):
    """Weights loaded in place after a generate, which left a decode state in
    the facade's cache: the next generate reuses the state and equals a
    facade built with those weights."""
    tmg, other = copy.deepcopy(pair[1]), get_debug_musicgen(device='cpu', seed=1)
    tmg._decode_cache.clear()
    for mg in (tmg, other):
        mg.set_generation_params(use_sampling=False, duration=2.0)
    before = tmg.generate(DESCRIPTIONS, return_tokens=True)[1]
    for name in ('compression_model', 'lm', 'condition_provider'):
        getattr(tmg, name).load_state_dict(getattr(other, name).state_dict())
    audio, after = tmg.generate(DESCRIPTIONS, return_tokens=True)
    assert len(tmg._decode_cache) == 1 and not torch.equal(before, after)
    ref_audio, ref = other.generate(DESCRIPTIONS, return_tokens=True)
    np.testing.assert_array_equal(after.numpy(), ref.numpy())
    np.testing.assert_array_equal(audio.numpy(), ref_audio.numpy())

def test_unconditional_and_continuation(pair):
    _, tmg = pair
    tmg.set_generation_params(duration=2.0, top_k=50)
    gen = torch.Generator().manual_seed(6)
    audio, tokens = tmg.generate_unconditional(3, generator=gen, return_tokens=True)
    assert tokens.shape == (3, 4, 50) and audio.shape == (3, 1, 50 * 1280)
    assert ((tokens >= 0) & (tokens < 400)).all() and torch.isfinite(audio).all()
    again = tmg.generate_unconditional(3, generator=torch.Generator().manual_seed(6),
                                       return_tokens=True)[1]
    assert torch.equal(tokens, again)

    prompt = np.random.RandomState(7).randn(2, 44100).astype(np.float32) * 0.1
    prompt_32k = audio_utils.convert_audio(torch.from_numpy(prompt)[None], 44100, 32000, 1)
    prompt_tokens = tmg.compression_model.encode(prompt_32k)[0]
    audio, tokens = tmg.generate_with_all(prompt[None], 44100, ['drums'], generator=gen,
                                          return_tokens=True)
    assert tokens.shape == (1, 4, 50) and audio.shape == (1, 1, 50 * 1280)
    np.testing.assert_array_equal(tokens[..., :prompt_tokens.shape[-1]].numpy(),
                                  prompt_tokens.numpy())
    tmg.decode_chunk_frames = 20   # past it: generate_audio decodes in windows
    try:
        chunked_audio = tmg.generate_audio(tokens)
    finally:
        tmg.decode_chunk_frames = 3000
    np.testing.assert_allclose(chunked_audio.numpy(), audio.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tmg.set_generation_params(duration=1.0)
        tmg.generate_continuation(torch.zeros(1, 1, 64000), 32000)


def test_unported_variants_raise(pair):
    """A model without a ``self_wav`` conditioner refuses a melody and the
    style settings with RuntimeError, as the JAX facade does."""
    jmg, tmg = pair
    for mg, kw in ((jmg, {}), (tmg, {})):
        with pytest.raises(RuntimeError):
            mg.set_style_conditioner_params(**kw)
    with pytest.raises(RuntimeError):
        tmg.generate_with_chroma(['x'], [np.zeros((1, 100), np.float32)], 32000)
    with pytest.raises(RuntimeError):
        tmg.generate_with_all(np.zeros((1, 1, 3200), np.float32), 32000,
                              melody_wavs=[np.zeros((1, 100), np.float32)])
    with pytest.raises(RuntimeError):
        jmg.generate_with_chroma(['x'], [np.zeros((1, 100), np.float32)], 32000)
    with pytest.raises(ValueError):   # double CFG needs a style (self_wav) condition
        drop_description_condition([ConditioningAttributes(text={'description': 'x'})])
    wav = WavCondition(np.zeros((1, 1, 4), np.float32), np.array([4]), [32000])
    dropped = drop_description_condition(
        [ConditioningAttributes(text={'description': 'x'}, wav={'self_wav': wav})])
    assert dropped[0].text['description'] is None and dropped[0].wav['self_wav'] is wav
