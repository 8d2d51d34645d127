"""The port's melody path against the JAX package, on the CPU: chroma, the
chroma conditioner, the prepended-condition decode, the debug
MusicGen-melody facade and the long-form extend utility.

Inputs are made from a seed with numpy; JAX weights (inits under ``jit``)
reach the port through ``ckpt/from_jax.py``.  Spectra and chroma compare
at 1e-5 (fp32 FFTs, only the order of the sums differs) and the one-hot
exactly but where the top two classes are within 1e-5; greedy tokens
exactly (both sides decode in fp32 on the CPU, first-index argmaxes);
audio at 1e-5.  The CPU's transposed convolutions are slow with many
threads at the debug codec's lengths, so the module runs torch on one
thread.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.builders import get_debug_compression_model as jax_debug_codec
from audiocraft_tpu.cond.chroma_cond import ChromaConditioner as JaxChromaConditioner
from audiocraft_tpu.cond.attributes import WavCondition as JaxWavCondition
from audiocraft_tpu.cond.conditioners import ConditioningProvider as JaxProvider
from audiocraft_tpu.cond.conditioners import LUTConditioner as JaxLUT
from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
from audiocraft_tpu.gen import extend as jax_extend
from audiocraft_tpu.gen.musicgen import MusicGen as JaxMusicGen
from audiocraft_tpu.lm.model import LMModel as JaxLM
from audiocraft_tpu.nn import chroma as jax_chroma
from audiocraft_tpu.patterns import DelayedPatternProvider as JaxDelayed
from audiocraft_tpu_torch.ckpt.from_jax import lm_state_from_jax, load_musicgen_from_jax
from audiocraft_tpu_torch.cond.attributes import WavCondition
from audiocraft_tpu_torch.cond.chroma_cond import ChromaConditioner
from audiocraft_tpu_torch.cond.conditioners import collate_wav_conditions
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.gen import extend
from audiocraft_tpu_torch.gen.musicgen import get_debug_melody_musicgen
from audiocraft_tpu_torch.lm import model as lm_model
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.nn import chroma
from audiocraft_tpu_torch.patterns import DelayedPatternProvider

GOLDENS = Path(__file__).parent / "goldens"
SR = 32000
# C, E, G, A#, D, F# and B above middle C
NOTE_HZ = (261.63, 329.63, 392.0, 466.16, 293.66, 369.99, 493.88)
NOTE_CLASS = (0, 4, 7, 10, 2, 6, 11)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _notes(seconds: float, seed: int, channels: int = 1, note_s: float = 0.5):
    """A seeded run of sine notes [channels, T] and each note's pitch class."""
    rng = np.random.RandomState(seed)
    picks = rng.randint(0, len(NOTE_HZ), max(1, int(round(seconds / note_s))))
    t = np.arange(int(note_s * SR)) / SR
    wav = np.concatenate([0.4 * np.sin(2 * np.pi * NOTE_HZ[p] * t) for p in picks])
    wav = wav[:int(seconds * SR)]
    wav = np.stack([wav * (1 - 0.2 * c) for c in range(channels)]).astype(np.float32)
    return wav, [NOTE_CLASS[p] for p in picks]


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ chroma
def test_filterbank_equals_the_golden():
    with np.load(GOLDENS / "chroma_fbank.npz") as g:
        np.testing.assert_allclose(chroma.chroma_filterbank(32000, 4096, 12),
                                   g["fb_32k_4096_12"], atol=1e-7)
        np.testing.assert_allclose(chroma.chroma_filterbank(22050, 512, 12, tuning=0.25),
                                   g["fb_22050_512_12_t025"], atol=1e-7)


@pytest.mark.parametrize("nfft,winlen,hop", [(4096, 4096, 1024), (512, 400, 160)])
def test_stft_power_matches_jax(nfft, winlen, hop):
    wav = np.random.RandomState(1).randn(2, 3, 9000).astype(np.float32)
    ref = np.asarray(jax_chroma.stft_power(jnp.asarray(wav), nfft, winlen, hop))
    out = chroma.stft_power(torch.from_numpy(wav), nfft, winlen, hop).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _one_hot_equal_but_near_ties(out, ref, raw):
    """One-hots equal wherever the raw chroma's top two classes are more
    than 1e-5 apart; returns the count of near-tie frames."""
    top2 = np.sort(raw, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) <= 1e-5
    np.testing.assert_array_equal(out[~near], ref[~near])
    return int(near.sum())


@pytest.mark.parametrize("channels,seconds", [(1, 3.0), (2, 2.0), (1, 0.05)])
def test_chroma_extractor_matches_jax(channels, seconds):
    wav = np.stack([_notes(seconds, seed=2 + b, channels=channels)[0] for b in range(2)])
    raw_j = jax_chroma.ChromaExtractor(sample_rate=SR, n_chroma=12, radix2_exp=12)
    raw_t = chroma.ChromaExtractor(sample_rate=SR, n_chroma=12, radix2_exp=12)
    ref = np.asarray(raw_j(jnp.asarray(wav)))
    out = raw_t(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    hot_j = jax_chroma.ChromaExtractor(sample_rate=SR, n_chroma=12, argmax=True)
    hot_t = chroma.ChromaExtractor(sample_rate=SR, n_chroma=12, argmax=True)
    hot = hot_t(torch.from_numpy(wav)).numpy()
    assert set(np.unique(hot)) <= {0.0, 1.0} and (hot.sum(-1) == 1).all()
    _one_hot_equal_but_near_ties(hot, np.asarray(hot_j(jnp.asarray(wav))), ref)


def test_each_note_hits_its_pitch_class():
    wav, classes = _notes(3.0, seed=5)
    hot = chroma.ChromaExtractor(sample_rate=SR, argmax=True)(torch.from_numpy(wav)[None])[0]
    per_note = hot.shape[0] / len(classes)
    for i, c in enumerate(classes):   # the frames well inside each note
        frames = hot[int((i + 0.3) * per_note):int((i + 0.7) * per_note)]
        assert (frames.argmax(-1) == c).all(), f'note {i}'


def test_nullified_melody_is_pitch_class_zero():
    """A zero wav gives all-zero chroma; the first-index argmax puts its
    one-hot at class 0 on every frame, as in JAX."""
    zero = torch.zeros(2, 1, 1)
    raw = chroma.ChromaExtractor(sample_rate=SR)(zero)
    assert raw.abs().max() == 0
    hot = chroma.ChromaExtractor(sample_rate=SR, argmax=True)(zero)
    assert (hot[..., 0] == 1).all() and hot.sum() == hot.shape[0] * hot.shape[1]
    ref = np.asarray(jax_chroma.ChromaExtractor(sample_rate=SR, argmax=True)(jnp.zeros((2, 1, 1))))
    np.testing.assert_array_equal(hot.numpy(), ref)


@pytest.mark.parametrize("match_len", [True, False])
def test_chroma_conditioner_matches_jax(match_len):
    jcond = JaxChromaConditioner(output_dim=16, sample_rate=SR, n_chroma=12, duration=2.0,
                                 match_len_on_eval=match_len)
    params = _np_tree(jcond.init(jax.random.PRNGKey(3)))
    tcond = ChromaConditioner(output_dim=16, sample_rate=SR, n_chroma=12, duration=2.0,
                              match_len_on_eval=match_len).eval()
    tcond.load_state_dict({'output_proj.weight': torch.tensor(params['output_proj']['weight']),
                           'output_proj.bias': torch.tensor(params['output_proj']['bias'])})
    assert tcond.chroma_len == jcond.chroma_len == 63
    # three rows: 3 s (truncated), 1 s (tiled) and a nullified melody
    rows = [WavCondition(_notes(3.0, seed=6)[0][None], np.array([3 * SR]), [SR], [None]),
            WavCondition(_notes(1.0, seed=7)[0][None], np.array([SR]), [SR], [None]),
            WavCondition(np.zeros((1, 1, 1), np.float32), np.zeros(1, np.int64), [SR], [None])]
    batch = collate_wav_conditions(rows)
    assert batch.wav.shape == (3, 1, 3 * SR) and list(batch.length) == [3 * SR, SR, 0]
    jbatch = JaxWavCondition(batch.wav, batch.length, batch.sample_rate, batch.path,
                             batch.seek_time)
    ref_e, ref_m = (np.asarray(a) for a in jcond(params, jbatch))
    out_e, out_m = tcond(tcond.tokenize(batch))
    np.testing.assert_array_equal(out_m.numpy(), ref_m)
    assert out_e.shape == ref_e.shape
    if match_len:
        assert out_e.shape[1] == 63 and (out_m == 1).all()
    else:
        assert out_m.sum(1).tolist() == [93, 31, 0]   # 96000 // 1024, 32000 // 1024
    np.testing.assert_allclose(out_e.numpy(), ref_e, rtol=1e-5, atol=1e-5)
    stems = tcond.tokenize(batch, stem_fn=lambda w: w * 0.5)
    np.testing.assert_allclose(stems.wav, batch.wav * 0.5)


# -------------------------------------------------- the prepended decode
PREPEND_FUSE = {'cross': ('description',), 'prepend': ('self_wav',)}
PREPEND_LM = dict(n_q=4, card=50, dim=32, num_heads=4, num_layers=2, cross_attention=True,
                  causal=True, norm_first=True)


@pytest.fixture(scope='module')
def prepend_pair():
    jlm = JaxLM(pattern_provider=JaxDelayed(4), fuser=JaxFuser.from_dict(PREPEND_FUSE),
                **PREPEND_LM)
    params = _np_tree(jax.jit(jlm.init)(jax.random.PRNGKey(4)))
    tlm = LMModel(ConditionFuser.from_dict(PREPEND_FUSE), pattern_provider=DelayedPatternProvider(4),
                  **PREPEND_LM).eval()
    tlm.load_state_dict(lm_state_from_jax(tlm, params), strict=True)
    return jlm, params, tlm


def _prepend_conditions(rows: int, prefix: int, seed: int):
    """(JAX, port) conditions: a description of 5 frames, one row partly
    masked, and a self_wav prefix of ``prefix`` frames."""
    rng = np.random.RandomState(seed)
    desc = rng.randn(rows, 5, 32).astype(np.float32)
    dmask = np.ones((rows, 5), np.int32)
    dmask[-1, 3:] = 0
    wav = rng.randn(rows, prefix, 32).astype(np.float32)
    wmask = np.ones((rows, prefix), np.int32)
    arrays = {'description': (desc * dmask[..., None], dmask), 'self_wav': (wav, wmask)}
    return ({k: (jnp.asarray(t), jnp.asarray(m)) for k, (t, m) in arrays.items()},
            {k: (torch.from_numpy(t), torch.from_numpy(m)) for k, (t, m) in arrays.items()})


@pytest.mark.parametrize("cfg_form", ['one_pass', 'two_step', 'double'])
def test_prepended_generate_equals_jax(prepend_pair, cfg_form):
    jlm, params, tlm = prepend_pair
    B, prefix = 2, 7
    prompt = np.random.RandomState(8).randint(0, 50, (B, 4, 3)).astype(np.int32)
    kw = dict(num_samples=B, max_gen_len=12, use_sampling=False, cfg_coef=2.5)
    if cfg_form == 'two_step':
        jc, tc = _prepend_conditions(B, prefix, seed=9)
        jn, tn = _prepend_conditions(B, prefix, seed=10)
        jcond, tcond = (jc, jn), (tc, tn)
    else:
        jcond, tcond = _prepend_conditions({'one_pass': 2, 'double': 3}[cfg_form] * B, prefix,
                                           seed=11)
    if cfg_form == 'double':
        kw['cfg_coef_beta'] = 1.5
    ref = np.asarray(jlm.generate(jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(0),
                                  condition_tensors=jcond, prompt=jnp.asarray(prompt), **kw))
    states: list = []
    out = tlm.generate(condition_tensors=tcond, prompt=torch.from_numpy(prompt),
                       _state_out=states, **kw)
    assert out.shape == ref.shape == (B, 4, 12)
    np.testing.assert_array_equal(out.numpy(), ref)
    # the caches hold the prefix before the pattern steps
    caches = states[0].caches[0]
    first = caches[0][0] if cfg_form == 'two_step' else caches[0]
    assert first.capacity == prefix + states[0].plan['S']


def test_prepended_generate_with_auto_buckets_equals_jax(prepend_pair):
    """kv_buckets='auto' over a 700-frame prefix: the first segment must hold
    the prefix and the prefill, so the ladder starts at 1024."""
    jlm, params, tlm = prepend_pair
    prefix, frames = 700, 340
    jcond, tcond = _prepend_conditions(2, prefix, seed=12)
    kw = dict(num_samples=1, max_gen_len=frames, use_sampling=False, cfg_coef=3.0,
              kv_buckets='auto')
    S = frames + 4   # the delay pattern's steps: a first special step and 3 of delay
    assert lm_model._plan_cache_segments(2, S, prefix, lm_model._auto_capacities(S + prefix)) \
        == [(2, 325, 1024), (325, S, S + prefix)]
    ref = np.asarray(jlm.generate(jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(0),
                                  condition_tensors=jcond, **kw))
    states: list = []
    out = tlm.generate(condition_tensors=tcond, _state_out=states, **kw)
    assert states[0].plan['S'] == S and states[0].plan['segments'][0] == (2, 325, 1024)
    assert [c[0].capacity for c in states[0].caches] == [1024, S + prefix]
    np.testing.assert_array_equal(out.numpy(), ref)
    full = tlm.generate(condition_tensors=tcond, **dict(kw, kv_buckets=None))
    np.testing.assert_array_equal(out.numpy(), full.numpy())


# ------------------------------------------------- the melody facade
@pytest.fixture(scope='module')
def melody_pair():
    """JAX's ``get_debug_melody_musicgen`` (inits under ``jit``) and the
    port's, holding the same weights; greedy decoding on both."""
    codec = jax_debug_codec(32000)
    provider = JaxProvider.from_dict({
        'description': JaxLUT(n_bins=128, dim=16, output_dim=16, tokenizer='whitespace'),
        'self_wav': JaxChromaConditioner(output_dim=16, sample_rate=SR, n_chroma=4,
                                         radix2_exp=12, duration=5.0)})
    lm = JaxLM(pattern_provider=JaxDelayed(4), fuser=JaxFuser.from_dict(
        {'cross': ('description',), 'prepend': ('self_wav',)}), n_q=4, card=400, dim=16,
        num_heads=4, num_layers=2, cross_attention=True, causal=True, norm_first=False,
        activation='relu')
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    jmg = JaxMusicGen(name='debug-melody', compression_model=codec,
                      codec_params=jax.jit(codec.init)(k1), lm=lm,
                      lm_params=jax.jit(lm.init)(k2), condition_provider=provider,
                      cond_params=provider.init(k3), max_duration=30.0, duration=5.0)
    tmg = get_debug_melody_musicgen(device='cpu')
    load_musicgen_from_jax(tmg, _np_tree(jmg.codec_params), _np_tree(jmg.lm_params),
                           _np_tree(jmg.cond_params))
    for mg in (jmg, tmg):
        mg.set_generation_params(use_sampling=False, duration=1.0)
    return jmg, tmg


def _set_both(pair, **kw):
    for mg in pair:
        mg.set_generation_params(use_sampling=False, **kw)


def test_generate_with_chroma_equals_jax(melody_pair):
    jmg, tmg = melody_pair
    _set_both(melody_pair, duration=1.0)
    melody = _notes(2.0, seed=13)[0]
    melody_64k = np.repeat(melody, 2, axis=-1)   # the notes at 64 kHz
    descriptions = ['follow this melody', 'no melody here']
    ref_audio, ref = jmg.generate_with_chroma(descriptions, [melody_64k, None], 64000,
                                              key=jax.random.PRNGKey(1), return_tokens=True)
    audio, out = tmg.generate_with_chroma(descriptions, [melody_64k, None], 64000,
                                          return_tokens=True)
    assert out.shape == (2, 4, 25) and audio.shape == (2, 1, 32000)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_allclose(audio.numpy(), np.asarray(ref_audio), rtol=1e-5, atol=1e-5)
    # a melody model with no melody at all: the [None] path
    ref = jmg.generate_with_chroma(['quiet now', 'and here'], [None, None], SR,
                                   key=jax.random.PRNGKey(2), return_tokens=True)[1]
    out = tmg.generate_with_chroma(['quiet now', 'and here'], [None, None], SR,
                                   return_tokens=True)[1]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_continuation_with_melody_equals_jax(melody_pair):
    jmg, tmg = melody_pair
    _set_both(melody_pair, duration=1.0)
    prompt = np.random.RandomState(14).randn(1, 1, 12800).astype(np.float32) * 0.1
    melody = _notes(2.0, seed=15, channels=2)[0]
    ref = jmg.generate_with_all(jnp.asarray(prompt), SR, ['drums'], melody_wavs=[melody],
                                melody_sample_rate=SR, key=jax.random.PRNGKey(3),
                                return_tokens=True)[1]
    out = tmg.generate_with_all(prompt, SR, ['drums'], melody_wavs=[melody],
                                melody_sample_rate=SR, return_tokens=True)[1]
    assert out.shape == (1, 4, 25)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_stride_extension_rewindows_the_melody_as_jax(melody_pair):
    """3 s in windows of 2 s with a 1 s stride: the second window hears the
    melody from 1 s on, wrapped at its length."""
    jmg, tmg = melody_pair
    for mg in melody_pair:
        mg.max_duration = 2.0
    try:
        _set_both(melody_pair, duration=3.0, extend_stride=1.0)
        melody = _notes(2.5, seed=16)[0]
        ref = jmg.generate_with_chroma(['a long line'], [melody], SR, key=jax.random.PRNGKey(4),
                                       return_tokens=True)[1]
        out = tmg.generate_with_chroma(['a long line'], [melody], SR, return_tokens=True)[1]
    finally:
        for mg in melody_pair:
            mg.max_duration = 30.0
        _set_both(melody_pair, duration=1.0)
    assert out.shape == (1, 4, 75)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generate_music_segments_equals_jax(melody_pair):
    jmg, tmg = melody_pair
    _set_both(melody_pair, duration=2.0, extend_stride=1.0)
    tokens = {'jax': [], 'port': []}

    def spy(mg, name):
        inner = mg._generate_tokens

        def record(*args, **kw):
            out = inner(*args, **kw)
            tokens[name].append(np.asarray(out))
            return out
        mg._generate_tokens = record
        return inner

    inner = {name: spy(mg, name) for name, mg in (('jax', jmg), ('port', tmg))}
    melody = _notes(4.0, seed=17)[0][0]
    try:
        ref, ref_excess = jax_extend.generate_music_segments(
            'looping melody', (SR, melody), seed=42, model=jmg, duration=4, overlap=1,
            segment_duration=2)
        out, excess = extend.generate_music_segments(
            'looping melody', (SR, melody), seed=42, model=tmg, duration=4, overlap=1,
            segment_duration=2)
    finally:
        jmg._generate_tokens, tmg._generate_tokens = inner['jax'], inner['port']
    assert extend.plan_segments(4, 2, 1) == jax_extend.plan_segments(4, 2, 1) == (3, 7, 1)
    assert excess == ref_excess and len(out) == len(ref) == 3
    assert len(tokens['port']) == len(tokens['jax']) == 4   # the prompt segment and 3
    for a, b in zip(tokens['port'], tokens['jax']):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    stitched = extend.stitch_segments(out, SR, overlap=1)
    ref_stitched = np.asarray(jax_extend.stitch_segments(ref, SR, overlap=1))
    assert stitched.shape[-1] == 3 * 2 * SR - 2 * SR // 2
    np.testing.assert_allclose(stitched.numpy(), ref_stitched, rtol=1e-5, atol=1e-5)
    assert tmg.duration == 2.0


def test_separate_and_stitch_match_jax():
    for n, seg, ov in ((SR * 5, 2, 1), (SR * 2, 2, 0), (SR * 7 + 100, 3, 1)):
        audio = (SR, np.arange(n, dtype=np.float32))
        ours = extend.separate_audio_segments(audio, seg, ov)
        theirs = jax_extend.separate_audio_segments(audio, seg, ov)
        assert len(ours) == len(theirs)
        for (_, a), (_, b) in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    for args in ((10, 30, 1), (20, 10, 1), (60, 20, 3), (800, 30, 20), (5, 5, 0)):
        assert extend.plan_segments(*args) == jax_extend.plan_segments(*args)
    assert extend.plan_segments(20, 10, 1) == (3, 21, 1)
    segs = [np.random.RandomState(i).randn(1, 2, 3 * 1000).astype(np.float32) for i in range(3)]
    for overlap in (0, 1):
        out = extend.stitch_segments([torch.from_numpy(s) for s in segs], 1000, overlap)
        ref = np.asarray(jax_extend.stitch_segments([jnp.asarray(s) for s in segs], 1000, overlap))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
