"""The port's style path against the JAX package, on the CPU: the RVQ eval
forward, the style conditioner and a debug MusicGen-style facade under
double CFG.

JAX weights (inits under ``jit``) reach the port through
``ckpt/from_jax.py``; inputs are made from a seed with numpy.  The
bottleneck's input and output compare at 1e-4 relative to their largest
value (fp32: a codec, a 4-layer transformer and the batch norm, whose sums
differ in order only), its codes and the greedy tokens exactly.  The
module runs torch on one thread, as the other facade tests do.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.builders import get_debug_compression_model as jax_debug_codec
from audiocraft_tpu.cond.attributes import WavCondition as JaxWavCondition
from audiocraft_tpu.cond.conditioners import ConditioningProvider as JaxProvider
from audiocraft_tpu.cond.conditioners import LUTConditioner as JaxLUT
from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
from audiocraft_tpu.cond.style_cond import StyleConditioner as JaxStyle
from audiocraft_tpu.gen.musicgen import MusicGen as JaxMusicGen
from audiocraft_tpu.lm.model import LMModel as JaxLM
from audiocraft_tpu.patterns import DelayedPatternProvider as JaxDelayed
from audiocraft_tpu.quant.vq import ResidualVectorQuantizer as JaxRVQ
from audiocraft_tpu.quant.vq import RVQState
from audiocraft_tpu_torch.builders import get_debug_compression_model, get_debug_musicgen_lm
from audiocraft_tpu_torch.ckpt.from_jax import (conditioners_state_from_jax,
                                                encodec_state_from_jax, load_musicgen_from_jax)
from audiocraft_tpu_torch.cond.attributes import WavCondition, nullify_wav
from audiocraft_tpu_torch.cond.conditioners import ConditioningProvider, LUTConditioner
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.cond.style_cond import StyleConditioner
from audiocraft_tpu_torch.gen.musicgen import MusicGen
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.patterns import DelayedPatternProvider
from audiocraft_tpu_torch.quant.vq import ResidualVectorQuantizer

SR = 32000
# tests/test_style_conditioner.py's configuration
STYLE = dict(output_dim=24, sample_rate=SR, encodec_n_q=2, length=0.5, transformer_scale='xsmall',
             ds_factor=2, n_q_out=4, eval_q=2, bins=64, use_middle_of_segment=True,
             num_codebooks_lm=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ RVQ forward
@pytest.mark.parametrize("n_q_active", [1, 3, 4])
def test_rvq_eval_forward_matches_jax(n_q_active):
    jrvq = JaxRVQ(dimension=32, n_q=4, bins=64, kmeans_init=False)
    state = jrvq.init(jax.random.PRNGKey(0))
    trvq = ResidualVectorQuantizer(dimension=32, n_q=4, bins=64)
    for q, layer in enumerate(trvq.vq.layers):
        layer._codebook.embed.copy_(torch.tensor(np.asarray(state.embed[q])))
    x = np.random.RandomState(1).randn(2, 32, 20).astype(np.float32)
    ref, _ = jrvq.forward(state, jnp.asarray(x), frame_rate=25.0, training=False,
                          n_q_active=jnp.asarray(n_q_active))
    out = trvq(torch.from_numpy(x), frame_rate=25.0, n_q_active=n_q_active)
    assert out.codes.shape == (2, n_q_active, 20) and out.codes.dtype == torch.int32
    np.testing.assert_array_equal(out.codes.numpy(), np.asarray(ref.codes)[:, :n_q_active])
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(out.bandwidth), float(ref.bandwidth), rtol=1e-6)
    np.testing.assert_allclose(float(out.penalty), float(ref.penalty), rtol=1e-5)
    # every active codebook's codes are the plain chain's
    np.testing.assert_array_equal(out.codes.numpy(),
                                  trvq.encode(torch.from_numpy(x)).numpy()[:, :n_q_active])
    with pytest.raises(ValueError):
        trvq(torch.from_numpy(x), frame_rate=25.0, n_q_active=5)


# ------------------------------------------------------- the conditioner
@pytest.fixture(scope='module')
def style_pair():
    codec = jax_debug_codec(32000)
    codec_params = jax.jit(codec.init)(jax.random.PRNGKey(0))
    jcond = JaxStyle(feat_extractor=codec, ds_rate_compression=codec.encoder.hop_length, **STYLE)
    params = _np_tree(jax.jit(lambda k: jcond.init(k, codec_params))(jax.random.PRNGKey(1)))
    tcond = StyleConditioner(feat_extractor=get_debug_compression_model(32000, device='cpu'),
                             ds_rate_compression=codec.encoder.hop_length, **STYLE).eval()
    provider = ConditioningProvider({'self_wav': tcond})
    provider.load_state_dict(conditioners_state_from_jax(provider, {'self_wav': params}),
                             strict=True)
    tcond.feat_extractor.load_state_dict(encodec_state_from_jax(tcond.feat_extractor,
                                                                params['codec']))
    return jcond, params, tcond


def _wavs(B: int, T: int, seed: int) -> WavCondition:
    wav = np.random.RandomState(seed).randn(B, 1, T).astype(np.float32) * 0.1
    return WavCondition(wav, np.full(B, T), [SR] * B, [None] * B, [None] * B)


def _jax(x: WavCondition) -> JaxWavCondition:
    return JaxWavCondition(*x)


def _jax_bottleneck(jcond, params, wav):
    """The JAX conditioner's steps up to its RVQ (its ``__call__`` written
    out), for the bottleneck's output and codes."""
    excerpt, _ = jcond.excerpt(jnp.asarray(wav))
    tokens, _ = jcond.feat_extractor.encode(params['codec'], excerpt)
    tokens = tokens[:, :jcond.encodec_n_q]
    z = sum(jnp.take(jnp.asarray(params['embed'][q]), tokens[:, q], axis=0)
            for q in range(jcond.encodec_n_q))
    z, _ = jcond.transformer(params['transformer'], z)
    z = (z - params['bn']['mean']) * jax.lax.rsqrt(params['bn']['var'] + 1e-5)
    state = params['rvq'] if isinstance(params['rvq'], RVQState) else RVQState(**params['rvq'])
    res, _ = jcond.rvq.forward(state, jnp.swapaxes(z, 1, 2), frame_rate=1.0,
                               n_q_active=jnp.asarray(jcond.eval_q), training=False)
    return np.swapaxes(np.asarray(res.x), 1, 2), np.asarray(res.codes)[:, :jcond.eval_q]


def test_style_conditioner_matches_jax(style_pair):
    jcond, params, tcond = style_pair
    x = _wavs(2, SR, seed=2)
    ref_e, ref_m = (np.asarray(a) for a in jcond(params, _jax(x)))
    out_e, out_m = tcond(tcond.tokenize(x))
    assert out_e.shape == ref_e.shape and out_e.shape[-1] == 24
    np.testing.assert_array_equal(out_m.numpy(), ref_m)
    assert _rel(out_e, ref_e) <= 1e-4
    ref_z, ref_codes = _jax_bottleneck(jcond, params, x.wav)
    z, codes = tcond.bottleneck(tcond.embed_tokens(tcond.excerpt_tokens(torch.from_numpy(x.wav))))
    assert codes.shape == ref_codes.shape == (2, 2, z.shape[1])
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    assert _rel(z, ref_z) <= 1e-4
    # the written-out steps are JAX's own
    own = ref_z[:, ::jcond.ds_factor] @ params['output_proj']['weight'].T \
        + params['output_proj']['bias']
    np.testing.assert_allclose(own * ref_m[..., None], ref_e, rtol=1e-5, atol=1e-6)


def test_style_conditioner_nullified_and_eval_q(style_pair):
    jcond, params, tcond = style_pair
    null = nullify_wav(_wavs(2, 100, seed=3))
    out_e, out_m = tcond(null)
    assert out_e.shape[:2] == (2, 1) and (out_m == 0).all() and (out_e == 0).all()
    ref_e, ref_m = (np.asarray(a) for a in jcond(params, _jax(null)))
    np.testing.assert_array_equal(out_e.numpy(), ref_e)
    x = _wavs(1, SR, seed=4)
    one = tcond.with_params(eval_q=1)
    assert one.eval_q == 1 and tcond.eval_q == 2 and one.embed is tcond.embed
    e1, e2 = one(x)[0], tcond(x)[0]
    assert not torch.allclose(e1, e2)
    ref1 = np.asarray(jcond.with_params(eval_q=1)(params, _jax(x))[0])
    assert _rel(e1, ref1) <= 1e-4
    with pytest.raises(ValueError):
        tcond.set_params(eval_q=5)


def test_excerpt_and_its_mask_match_jax(style_pair):
    jcond, params, tcond = style_pair
    x = _wavs(2, 3 * SR, seed=5)
    for start in (0, SR, 2 * SR):
        np.testing.assert_array_equal(tcond.excerpt_mask(x, start),
                                      jcond.excerpt_mask(_jax(x), start))
    assert tcond.excerpt_mask(nullify_wav(x), 0) is None
    assert tcond.excerpt_start(3 * SR) == int(jcond.excerpt(jnp.zeros((1, 1, 3 * SR)))[1])
    drawn = StyleConditioner(feat_extractor=tcond.feat_extractor,
                             **dict(STYLE, use_middle_of_segment=False))
    starts = {drawn.excerpt_start(3 * SR, torch.Generator().manual_seed(s)) for s in range(8)}
    assert len(starts) > 1 and all(0 <= s <= 3 * SR - SR // 2 for s in starts)
    assert drawn.excerpt_start(3 * SR) == SR + SR // 4   # no generator: the middle
    # the hidden codec is out of the state dict and follows the module
    assert not any(k.startswith('feat_extractor') for k in tcond.state_dict())
    moved = drawn.to(torch.float64)
    assert moved.feat_extractor.quantizer.vq.layers[0]._codebook.embed.dtype == torch.float64
    drawn.to(torch.float32)


# ------------------------------------------------------------ the facade
def _jax_style_musicgen():
    codec = jax_debug_codec(32000)
    style_codec = jax_debug_codec(32000)
    style = JaxStyle(feat_extractor=style_codec, ds_rate_compression=style_codec.encoder.hop_length,
                     **dict(STYLE, output_dim=16))
    provider = JaxProvider.from_dict({
        'description': JaxLUT(n_bins=128, dim=16, output_dim=16, tokenizer='whitespace'),
        'self_wav': style})
    lm = JaxLM(pattern_provider=JaxDelayed(4), fuser=JaxFuser.from_dict(
        {'cross': ('description',), 'prepend': ('self_wav',)}), n_q=4, card=400, dim=16,
        num_heads=4, num_layers=2, cross_attention=True, causal=True, norm_first=False,
        activation='relu')
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(6), 4)
    cond_params = {
        'description': provider.as_dict['description'].init(k3),
        'self_wav': jax.jit(lambda k: style.init(k, jax.jit(style_codec.init)(k4)))(k3)}
    return JaxMusicGen(name='debug-style', compression_model=codec,
                       codec_params=jax.jit(codec.init)(k1), lm=lm,
                       lm_params=jax.jit(lm.init)(k2), condition_provider=provider,
                       cond_params=cond_params, max_duration=30.0, duration=1.0)


def _port_style_musicgen():
    codec = get_debug_compression_model(32000, device='cpu')
    lm, provider = get_debug_musicgen_lm(device='cpu')
    style = StyleConditioner(feat_extractor=get_debug_compression_model(32000, device='cpu'),
                             ds_rate_compression=codec.encoder.hop_length,
                             **dict(STYLE, output_dim=16)).eval()
    provider = ConditioningProvider({'description': provider.conditioners['description'],
                                     'self_wav': style})
    lm = LMModel(ConditionFuser.from_dict({'cross': ('description',), 'prepend': ('self_wav',)}),
                 n_q=4, card=400, dim=16, num_heads=4, num_layers=2, cross_attention=True,
                 causal=True, norm_first=False, activation='relu',
                 pattern_provider=DelayedPatternProvider(4)).eval()
    return MusicGen('debug-style', codec, lm, provider, max_duration=30.0, duration=1.0)


def test_style_facade_double_cfg_greedy_equals_jax():
    jmg = _jax_style_musicgen()
    tmg = _port_style_musicgen()
    load_musicgen_from_jax(tmg, _np_tree(jmg.codec_params), _np_tree(jmg.lm_params),
                           _np_tree(jmg.cond_params))
    for mg in (jmg, tmg):
        mg.set_generation_params(use_sampling=False, duration=1.0, cfg_coef=3.0,
                                 cfg_coef_beta=5.0)
    clips = [np.random.RandomState(7 + i).randn(1, 2 * SR).astype(np.float32) * 0.1
             for i in range(2)]
    descriptions = ['warm strings', 'bright brass']
    ref = jmg.generate_with_chroma(descriptions, clips, SR, key=jax.random.PRNGKey(1),
                                   return_tokens=True)[1]
    out = tmg.generate_with_chroma(descriptions, clips, SR, return_tokens=True)[1]
    assert out.shape == (2, 4, 25)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # a lighter bottleneck, set on both facades: the style rows move by
    # ~5e-8 between the packages, and the double-CFG guidance (cfg_coef 3 x
    # beta 5) turns that into one flipped near-tie at the last step; fed
    # JAX's own condition tensors, the port's decode gives JAX's tokens
    for mg in (jmg, tmg):
        mg.set_style_conditioner_params(eval_q=1, excerpt_length=0.4)
    assert tmg.condition_provider.conditioners['self_wav'].eval_q == 1
    ref = np.asarray(jmg.generate_with_chroma(descriptions, clips, SR, key=jax.random.PRNGKey(1),
                                              return_tokens=True)[1])
    out = tmg.generate_with_chroma(descriptions, clips, SR, return_tokens=True)[1]
    attributes, _ = jmg._prepare_tokens_and_attributes(descriptions, None, melody_wavs=clips)
    jconds = {k: (torch.tensor(np.asarray(t)), torch.tensor(np.asarray(m)))
              for k, (t, m) in jmg._cfg_condition_tensors(attributes).items()}
    kw = dict(num_samples=2, max_gen_len=25, use_sampling=False, cfg_coef=3.0, cfg_coef_beta=5.0)
    np.testing.assert_array_equal(tmg.lm.generate(condition_tensors=jconds, **kw).numpy(), ref)
    _equal_or_near_tie(tmg, descriptions, clips, out, ref, kw)


def _equal_or_near_tie(tmg, descriptions, clips, out, ref, kw):
    """The facade's tokens equal ``ref``, or first differ where the port's
    guided logits have their top two within 1e-5 relative."""
    diff = np.argwhere(out.numpy() != ref)
    if not len(diff):
        return
    attributes, _ = tmg._prepare_tokens_and_attributes(descriptions, None, melody_wavs=clips)
    conds = tmg._cfg_condition_tensors(attributes)
    states: list = []
    tmg.lm.generate(condition_tensors=conds, _state_out=states, **kw)
    seq = states[0].seq
    step = int(min(t + k + 1 for _, k, t in diff))   # the delay pattern's step
    b, k, _ = next(d for d in diff if d[2] + d[1] + 1 == step)
    with torch.no_grad():
        logits = tmg.lm(torch.cat([seq[..., :step]] * 3), conds)[:, :, -1]
    top2 = tmg.lm._combine_cfg(logits, 2, True, 3.0, 5.0)[b, k].topk(2).values
    assert float((top2[0] - top2[1]) / top2[0].abs()) < 1e-5, f'step {step}: not a near-tie'
