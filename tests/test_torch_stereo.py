"""The port's stereo codec wrapper and MusicGen-stereo wiring against the JAX
package, on the CPU.

The debug codec holds the golden weights (``tests/goldens``) on both sides;
the debug stereo facade's LM and conditioner come from the JAX init through
``ckpt/from_jax.load_musicgen_from_jax``.  Codes and greedy tokens compare
exactly (fp32), audio within 1e-5 (fp32 convs; only the order of the sums
differs).  Torch runs on one thread here: the CPU's transposed convs at the
debug codec's lengths take seconds with several.
"""

import copy
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.builders import get_debug_compression_model as jax_debug_codec
from audiocraft_tpu.builders import get_wrapped_compression_model as jax_wrap
from audiocraft_tpu.ckpt.torch_import import import_encodec
from audiocraft_tpu.codec import chunked as jax_chunked
from audiocraft_tpu.cond.conditioners import ConditioningProvider as JaxProvider
from audiocraft_tpu.cond.conditioners import LUTConditioner as JaxLUT
from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
from audiocraft_tpu.gen.musicgen import MusicGen as JaxMusicGen
from audiocraft_tpu.lm.model import LMModel as JaxLM
from audiocraft_tpu.patterns import DelayedPatternProvider as JaxDelayed
from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.ckpt.from_jax import encodec_state_from_jax, load_musicgen_from_jax
from audiocraft_tpu_torch.codec import chunked
from audiocraft_tpu_torch.codec.stereo import InterleaveStereoCompressionModel
from audiocraft_tpu_torch.cond.conditioners import ConditioningProvider, LUTConditioner
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.gen import musicgen as port_musicgen
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.patterns import DelayedPatternProvider

GOLDENS = Path(__file__).parent / "goldens"
DESCRIPTIONS = ['a short jingle', 'calm piano at night']


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def codecs():
    """(JAX debug codec, its params, the port's debug codec), golden weights."""
    jmodel = jax_debug_codec(32000)
    with np.load(GOLDENS / "debug_codec_state.npz") as data:
        params = import_encodec(jmodel, {k: data[k] for k in data.files})
    port = builders.get_debug_compression_model(32000, device='cpu')
    port.load_state_dict(encodec_state_from_jax(port, jax.tree.map(np.asarray, params)))
    return jmodel, jax.tree.map(jnp.asarray, params), port


def _stereo_wav(T, B=2, seed=0):
    return np.random.RandomState(seed).randn(B, 2, T).astype(np.float32) * 0.3


@pytest.mark.parametrize("per_timestep", [False, True])
def test_stereo_codes_equal_jax(codecs, per_timestep):
    """Both interleavings: codes, their left / right split and the decode
    against JAX's wrapper; the codes are the mono codec's of each channel."""
    jmodel, params, port = codecs
    jstereo = jax_wrap(jmodel, interleave_stereo=True, per_timestep=per_timestep)
    stereo = builders.get_wrapped_compression_model(port, interleave_stereo=True,
                                                    per_timestep=per_timestep)
    assert isinstance(stereo, InterleaveStereoCompressionModel)
    for name in ('num_codebooks', 'total_codebooks', 'frame_rate', 'sample_rate', 'channels',
                 'cardinality', 'num_virtual_steps'):
        assert getattr(stereo, name) == getattr(jstereo, name), name
    wav = _stereo_wav(12800)
    ref, ref_scale = jstereo.encode(params, jnp.asarray(wav))
    codes, scale = stereo.encode(torch.from_numpy(wav))
    assert scale is None and ref_scale is None
    assert codes.shape == ((2, 8, 10) if not per_timestep else (2, 4, 20))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
    left, right = stereo.get_left_right_codes(codes)
    jleft, jright = jstereo.get_left_right_codes(jnp.asarray(codes.numpy()))
    np.testing.assert_array_equal(left.numpy(), np.asarray(jleft))
    np.testing.assert_array_equal(right.numpy(), np.asarray(jright))
    np.testing.assert_array_equal(left.numpy(), port.encode(torch.from_numpy(wav[:, :1]))[0])
    np.testing.assert_array_equal(right.numpy(), port.encode(torch.from_numpy(wav[:, 1:]))[0])
    out = stereo.decode(codes)
    jout = np.asarray(jstereo.decode(params, jnp.asarray(codes.numpy())))
    assert out.shape == jout.shape == (2, 2, 12800)
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)


def test_stereo_scales_and_set_num_codebooks(codecs):
    """A renormalizing codec's scale pairs [B, 2] and the decode that takes
    them; ``n_q`` and ``set_num_codebooks`` act on the wrapped codec in place
    (the JAX package returns new models)."""
    jmodel, params, port = codecs
    jstereo = jax_wrap(dataclasses.replace(jmodel, renormalize=True), interleave_stereo=True)
    norm = copy.deepcopy(port)
    norm.renormalize = True
    stereo = builders.get_wrapped_compression_model(norm, interleave_stereo=True)
    wav = _stereo_wav(6400, seed=1)
    wav[:, 1] *= 3   # the channels at other levels
    ref, ref_scale = jstereo.encode(params, jnp.asarray(wav))
    codes, scale = stereo.encode(torch.from_numpy(wav))
    assert scale.shape == np.shape(ref_scale) == (2, 2, 1)
    np.testing.assert_allclose(scale.numpy(), np.asarray(ref_scale), rtol=1e-6)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
    np.testing.assert_allclose(stereo.decode(codes, scale).numpy(),
                               np.asarray(jstereo.decode(params, ref, ref_scale)),
                               rtol=1e-5, atol=1e-5)
    stereo.set_num_codebooks(2)
    assert (stereo.num_codebooks, norm.num_codebooks, stereo.total_codebooks) == (4, 2, 4)
    assert jstereo.set_num_codebooks(2).num_codebooks == 4
    two, _ = stereo.encode(torch.from_numpy(wav))
    np.testing.assert_array_equal(two.numpy(), codes[:, :4].numpy())
    wrapped = builders.get_wrapped_compression_model(copy.deepcopy(port), n_q=3)
    assert not isinstance(wrapped, InterleaveStereoCompressionModel)
    assert wrapped.num_codebooks == jax_wrap(jmodel, n_q=3).num_codebooks == 3
    with pytest.raises(ValueError):
        InterleaveStereoCompressionModel(stereo)   # a stereo codec is not mono


def test_stereo_chunked_decode_equals_jax(codecs):
    """The stereo branch of ``chunked_decode``: both channels at doubled
    batch through the windows, within 1e-5 of JAX's and of the whole decode."""
    jmodel, params, port = codecs
    jstereo = jax_wrap(jmodel, interleave_stereo=True)
    stereo = builders.get_wrapped_compression_model(port, interleave_stereo=True)
    codes = np.random.RandomState(4).randint(0, 400, (1, 8, 130)).astype(np.int64)
    ref = np.asarray(jax_chunked.chunked_decode(jstereo, params, jnp.asarray(codes),
                                                chunk_frames=40))
    out = chunked.chunked_decode(stereo, torch.from_numpy(codes), chunk_frames=40)
    whole = stereo.decode(torch.from_numpy(codes))
    assert out.shape == ref.shape == whole.shape == (1, 2, 130 * 1280)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def stereo_pair(codecs):
    """A debug stereo MusicGen on each side (JAX's built as
    ``tests/test_musicgen_facade.py:test_stereo_facade_generate`` builds it),
    holding the same weights."""
    jmodel, params, port = codecs
    jcodec = jax_wrap(jmodel, interleave_stereo=True)
    jlm = JaxLM(pattern_provider=JaxDelayed(8), fuser=JaxFuser.from_dict({'cross': (
        'description',)}), n_q=8, card=400, dim=16, num_heads=4, num_layers=2,
        cross_attention=True, causal=True, norm_first=False, activation='relu')
    jprovider = JaxProvider.from_dict({'description': JaxLUT(
        n_bins=64, dim=16, output_dim=16, tokenizer='whitespace')})
    k2, k3 = jax.random.split(jax.random.PRNGKey(5))
    jmg = JaxMusicGen(name='musicgen-stereo-debug', compression_model=jcodec,
                      codec_params=params, lm=jlm, lm_params=jax.jit(jlm.init)(k2),
                      condition_provider=jprovider, cond_params=jprovider.init(k3),
                      max_duration=30.0, duration=1.0)
    lm = LMModel(ConditionFuser.from_dict({'cross': ('description',)}), n_q=8, card=400,
                 dim=16, num_heads=4, num_layers=2, cross_attention=True, causal=True,
                 norm_first=False, activation='relu', pattern_provider=DelayedPatternProvider(8))
    provider = ConditioningProvider.from_dict({'description': LUTConditioner(
        n_bins=64, dim=16, output_dim=16, tokenizer='whitespace')})
    tmg = port_musicgen.MusicGen(
        'musicgen-stereo-debug',
        builders.get_wrapped_compression_model(copy.deepcopy(port), interleave_stereo=True),
        lm.eval().requires_grad_(False), provider.eval().requires_grad_(False),
        max_duration=30.0, duration=1.0)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    load_musicgen_from_jax(tmg, np_tree(jmg.codec_params), np_tree(jmg.lm_params),
                           np_tree(jmg.cond_params))
    return jmg, tmg


def test_stereo_facade_greedy_tokens_equal_jax(stereo_pair):
    jmg, tmg = stereo_pair
    assert tmg.audio_channels == jmg.audio_channels == 2
    for mg in (jmg, tmg):
        mg.set_generation_params(use_sampling=False, duration=1.0)
    ref_audio, ref = jmg.generate(DESCRIPTIONS, jax.random.PRNGKey(0), return_tokens=True)
    audio, tokens = tmg.generate(DESCRIPTIONS, return_tokens=True)
    assert tokens.shape == (2, 8, 25) and ((tokens >= 0) & (tokens < 400)).all()
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    assert audio.shape == np.shape(ref_audio) == (2, 2, 25 * 1280)
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), rtol=1e-5, atol=1e-5)


def test_long_stereo_prompt_takes_the_whole_encode(stereo_pair, monkeypatch):
    """Past ``decode_chunk_frames`` a mono codec's prompt encodes in windows;
    a stereo wrapper's takes the whole encode, as in the JAX facade, whose
    tokens it equals; a long stereo decode still goes through the windows."""
    jmg, tmg = stereo_pair
    prompt = np.random.RandomState(9).randn(1, 2, 40 * 1280).astype(np.float32) * 0.1
    calls = []
    monkeypatch.setattr(port_musicgen, 'chunked_encode', lambda *a, **k: calls.append(1))
    old = tmg.decode_chunk_frames, jmg.decode_chunk_frames
    try:
        tmg.decode_chunk_frames = jmg.decode_chunk_frames = 32
        _, tokens = tmg._prepare_tokens_and_attributes(['x'], torch.from_numpy(prompt))
        _, ref = jmg._prepare_tokens_and_attributes(['x'], jnp.asarray(prompt))
        windowed = tmg.generate_audio(tokens)
    finally:
        tmg.decode_chunk_frames, jmg.decode_chunk_frames = old
    assert calls == [] and tokens.shape == (1, 8, 40)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tokens.numpy(),
                                  tmg.compression_model.encode(torch.from_numpy(prompt))[0])
    np.testing.assert_allclose(windowed.numpy(), tmg.generate_audio(tokens).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_get_musicgen_stereo_wiring(monkeypatch):
    """``get_musicgen(size, stereo=True)``: the 32 kHz codec wrapped, an LM of
    ``codec.num_codebooks`` (8) codebooks, the published name; the codec and
    LM factories are stood in for by thin ones here (the published widths
    run on the card, in chip_smoke.py)."""
    made = {}

    def thin_lm(size, n_q, device, seed, melody=False, style=False):
        assert not (melody or style)
        made['lm'] = (size, n_q)
        return builders.get_debug_musicgen_lm(device=device, seed=seed)

    monkeypatch.setattr(builders, 'get_encodec_32khz', lambda device, seed: (
        builders.get_debug_compression_model(32000, device=device, seed=seed)))
    monkeypatch.setattr(builders, 'get_musicgen_lm', thin_lm)
    mg = builders.get_musicgen('small', stereo=True, device='cpu')
    assert mg.name == 'musicgen-stereo-small' and made['lm'] == ('small', 8)
    assert isinstance(mg.compression_model, InterleaveStereoCompressionModel)
    assert mg.audio_channels == 2 and mg.compression_model.num_codebooks == 8
    mono = builders.get_musicgen('small', device='cpu')
    assert mono.name == 'musicgen-small' and made['lm'] == ('small', 4)
    assert mono.audio_channels == 1
