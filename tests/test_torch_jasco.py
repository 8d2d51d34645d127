"""The port's JASCO against the JAX package, on the CPU: the flow model's
vector field with 1 and 3 CFG terms, the Euler, Heun and dopri5 generates
from JAX's drawn ``z0``, each conditioner, the provider's padding, the
drums' temporal blur, the drums path on the debug codec, and
``get_jasco_model``'s parameters against JAX's builder.

Widths are tests/test_jasco_flow.py's debug ones (dim 32, 4 heads, 4
layers, flow_dim 16), with chords, drums and melody streams.  The JAX
weights are the port's seeded init written into JAX's tree through
``ckpt/from_jax.py``'s mapping run backwards (``jax_tree_from_port``), which
saves JAX's init compile.  JAX keeps its default ``attn_kernel=False``, so
no test reaches the Pallas interpreter; its calls run under ``jax.jit``.
Tolerances (fp32, sums in another order): the vector field within 1e-5 of
its largest value; the Euler, Heun and dopri5 latents within 1e-4; dopri5's
accepted steps equal; each conditioner's output within 1e-5 of its largest
value, and the codec's codes equal.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu import builders as jax_builders
from audiocraft_tpu.cond.attributes import ConditioningAttributes as JaxAttributes
from audiocraft_tpu.cond.attributes import SymbolicCondition as JaxSymbolic
from audiocraft_tpu.cond.attributes import WavCondition as JaxWav
from audiocraft_tpu.cond.conditioners import LUTConditioner as JaxLUT
from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
from audiocraft_tpu.cond.jasco_conditioners import (ChordsEmbConditioner as JaxChords,
                                                    DrumsConditioner as JaxDrums,
                                                    JascoConditioningProvider as JaxProvider,
                                                    MelodyConditioner as JaxMelody)
from audiocraft_tpu.lm import flow_matching as jax_flow
from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.ckpt.from_jax import (conditioners_state_from_jax,
                                                encodec_state_from_jax,
                                                flow_matching_state_from_jax, load_jasco_from_jax)
from audiocraft_tpu_torch.cond.attributes import (ConditioningAttributes, SymbolicCondition,
                                                  WavCondition)
from audiocraft_tpu_torch.cond.conditioners import LUTConditioner
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.cond.jasco_conditioners import (ChordsEmbConditioner,
                                                          DrumsConditioner,
                                                          JascoConditioningProvider,
                                                          MelodyConditioner)
from audiocraft_tpu_torch.lm.flow_matching import FlowMatchingModel, timestep_embedding
from chip_smoke import seed_codebooks, set_attn_kernel
from test_torch_codec_train import jax_tree_from_port

WIDTHS = dict(dim=32, num_heads=4, num_layers=4, flow_dim=16, chords_dim=8, drums_dim=4,
              melody_dim=6, hidden_scale=2, time_embedding_dim=16)
B, T, SEQ = 2, 20, 24
CFG_3 = (2.0, -0.5, -0.5)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def flow_pair():
    jm = jax_flow.FlowMatchingModel(fuser=JaxFuser.from_dict({'cross': ('description',)}),
                                    **WIDTHS)
    tm = FlowMatchingModel(ConditionFuser.from_dict({'cross': ('description',)}),
                           generator=torch.Generator().manual_seed(0), **WIDTHS).eval()
    params = jax_tree_from_port(jm.init, tm.state_dict(),
                                functools.partial(flow_matching_state_from_jax, tm))
    return jm, params, tm


def _conditions(n_terms: int, seed: int = 0):
    """Condition tensors for ``n_terms`` CFG groups of B rows: the text for
    cross-attention, and chords, drums and melody longer, shorter and as
    long as the latents."""
    rng = np.random.RandomState(seed)
    n = n_terms * B
    arrays = {'description': (rng.randn(n, 5, 32), np.ones((n, 5))),
              'chords': (rng.randn(n, T + 5, 8), np.ones((n, T + 5))),
              'self_wav': (rng.randn(n, T - 3, 4), np.ones((n, T - 3))),
              'melody': (rng.randn(n, T, 6), np.ones((n, T)))}
    arrays = {k: (e.astype(np.float32), m.astype(np.int32)) for k, (e, m) in arrays.items()}
    jax_conds = {k: (jnp.asarray(e), jnp.asarray(m)) for k, (e, m) in arrays.items()}
    torch_conds = {k: (torch.from_numpy(e), torch.from_numpy(m)) for k, (e, m) in arrays.items()}
    return jax_conds, torch_conds


@pytest.mark.parametrize('dim', [16, 17])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0.0, 0.25, 0.9, 1.0], np.float32)
    ref = np.asarray(jax_flow.timestep_embedding(jnp.asarray(t), dim))
    np.testing.assert_allclose(timestep_embedding(torch.from_numpy(t), dim).numpy(), ref,
                               atol=1e-6)


@pytest.mark.parametrize('cfg_weights', [(1.0,), CFG_3], ids=['1-term', '3-terms'])
def test_vector_field_matches_jax(flow_pair, cfg_weights):
    """One evaluation within 1e-5 of its largest value."""
    jm, params, tm = flow_pair
    jc, tc = _conditions(len(cfg_weights))
    z = np.random.RandomState(1).randn(B, T, 16).astype(np.float32)
    ref = jax.jit(lambda z, t: jm.estimated_vector_field(params, z, t, jc, cfg_weights))(
        jnp.asarray(z), jnp.float32(0.3))
    out = tm.estimated_vector_field(torch.from_numpy(z), torch.tensor(0.3), tc, cfg_weights)
    assert out.shape == (B, T, 16)
    assert _rel(out, ref) < 1e-5


@pytest.mark.parametrize('method,steps', [('euler', 4), ('heun', 2)])
def test_fixed_step_generate_matches_jax(flow_pair, method, steps):
    """JAX's generate from its key; the port integrates from JAX's drawn
    z0: latents within 1e-4 of their largest value."""
    jm, params, tm = flow_pair
    jc, tc = _conditions(3)
    key = jax.random.PRNGKey(2)
    ref = jax.jit(lambda k: jm.generate(params, k, jc, cfg_weights=CFG_3, num_samples=B,
                                        max_gen_len=T, euler_steps=steps, method=method))(key)
    z0 = torch.from_numpy(np.array(jax.random.normal(key, (B, T, 16))))
    out = tm._integrate(z0, tc, CFG_3, euler_steps=steps, method=method)
    assert _rel(out, ref) < 1e-4
    assert tm.ode_stats == dict(trials=steps, accepted=steps,
                                evals=steps * (2 if method == 'heun' else 1), host_reads=0)


def _jax_dopri5_trace(vf, z0, atol, rtol):
    """JAX's solver (``_dopri5``) under ``jax.jit`` on the field ``vf``,
    with the time of every evaluation recorded -> (z, trial steps, accepted
    steps).  Trial step j evaluates at t_j + c_i dt_j; it was accepted
    exactly when the next trial's first time (c = 1/5) lies past its last
    (c = 1): a rejected step keeps t_j and cuts dt below 0.9 dt_j, an
    accepted one starts the next at t_j + dt_j."""
    times = []

    def traced(z, t):
        jax.debug.callback(lambda tt: times.append(float(tt)), t, ordered=True)
        return vf(z, t)

    z = np.asarray(jax.jit(lambda z0: jax_flow._dopri5(traced, z0, t1=1.0 - 1e-5, atol=atol,
                                                       rtol=rtol, max_steps=512))(z0))
    jax.effects_barrier()
    trials = np.asarray(times[1:]).reshape(-1, 6)
    accepted = int((trials[1:, 0] > trials[:-1, 5]).sum()) + 1    # the last reaches t1
    return z, len(trials), accepted


def test_dopri5_matches_jax(flow_pair):
    """dopri5 on the flow model with its head scaled by 30, so that the
    controller reads truncation error rather than fp32 rounding (at scale 1
    the two sides' step sizes part by a few per cent): the same trial and
    accepted steps, latents within 1e-4, one host read a trial step."""
    jm, params, tm = flow_pair
    jc, tc = _conditions(3)
    jparams = {**params, 'linear': {**params['linear'],
                                    'weight': params['linear']['weight'] * 30}}
    state = tm.state_dict()
    model = FlowMatchingModel(ConditionFuser.from_dict({'cross': ('description',)}),
                              **WIDTHS).eval()
    model.load_state_dict({**state, 'linear.weight': state['linear.weight'] * 30})
    z0 = np.random.RandomState(3).randn(B, T, 16).astype(np.float32)
    ref, trials, accepted = _jax_dopri5_trace(
        lambda z, t: jm.estimated_vector_field(jparams, z, t, jc, CFG_3), jnp.asarray(z0),
        1e-5, 1e-5)
    out = model._integrate(torch.from_numpy(z0), tc, CFG_3, method='dopri5', ode_atol=1e-5,
                           ode_rtol=1e-5)
    assert trials > 5
    assert model.ode_stats == dict(trials=trials, accepted=accepted, evals=1 + 6 * trials,
                                   host_reads=trials)
    assert _rel(out, ref) < 1e-4


def test_dopri5_rejects_steps_as_jax_does():
    """The controller on a stiff forced field, dz/dt = -40 (z - sin 25t),
    where steps are rejected: the same trial and accepted steps as JAX's
    solver, the result within 1e-4."""
    from audiocraft_tpu_torch.lm.flow_matching import _dopri5
    z0 = np.random.RandomState(8).randn(2, 3, 4).astype(np.float32)
    ref, trials, accepted = _jax_dopri5_trace(
        lambda z, t: -40.0 * (z - jnp.sin(25.0 * t)), jnp.asarray(z0), 1e-5, 1e-5)
    out, stats = _dopri5(lambda z, t: -40.0 * (z - torch.sin(25.0 * t)), torch.from_numpy(z0),
                         1.0 - 1e-5, 1e-5, 1e-5, 512)
    assert trials > accepted
    assert (stats['trials'], stats['accepted']) == (trials, accepted)
    assert _rel(out, ref) < 1e-4


def test_generate_draws_z0_from_the_generator(flow_pair):
    _, _, tm = flow_pair
    _, tc = _conditions(1)
    out = tm.generate(tc, num_samples=B, max_gen_len=T, euler_steps=2,
                      generator=torch.Generator().manual_seed(5))
    z0 = torch.randn(B, T, 16, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(out, tm._integrate(z0, tc, euler_steps=2), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tm._integrate(z0, tc, method='rk4')


def test_attn_kernel_route_on_the_cpu_matches_the_plain_path(flow_pair):
    """attn_kernel routes the U-net's self-attention to K3f's plain version
    on a CPU tensor: within 1e-5 of the plain path's field."""
    _, _, tm = flow_pair
    _, tc = _conditions(3)
    z = torch.from_numpy(np.random.RandomState(4).randn(B, T, 16).astype(np.float32))
    plain = tm.estimated_vector_field(z, torch.tensor(0.5), tc, CFG_3)
    set_attn_kernel(tm, 'auto')
    try:
        routed = tm.estimated_vector_field(z, torch.tensor(0.5), tc, CFG_3)
    finally:
        set_attn_kernel(tm, False)
    assert _rel(routed, plain) < 1e-5


# ---------------------------------------------------------- conditioners
@pytest.fixture(scope='module')
def codec_pair():
    """The debug 32 kHz codec on both sides, its codebooks seeded from its
    own latents (``chip_smoke.seed_codebooks``), so that codes spread."""
    port = builders.get_debug_compression_model(32000, device='cpu')
    seed_codebooks(port, torch.from_numpy(
        np.random.RandomState(0).randn(10, 1, 64000).astype(np.float32) * 0.1))
    model = jax_builders.get_debug_compression_model(32000)
    params = jax_tree_from_port(model.init, port.state_dict(),
                                functools.partial(encodec_state_from_jax, port))
    return model, params, port


@pytest.fixture(scope='module')
def provider_pair(codec_pair):
    jcodec, jcodec_params, tcodec = codec_pair
    kw = dict(compression_model_latent_dim=32)
    jp = JaxProvider.from_dict({
        'description': JaxLUT(n_bins=64, dim=8, output_dim=8, tokenizer='whitespace'),
        'chords': JaxChords(card=194, out_dim=8), 'melody': JaxMelody(card=53, out_dim=8),
        'self_wav': JaxDrums(feat_extractor=jcodec, out_dim=8, compression_model_framerate=25,
                             **kw)},
        sequence_length=SEQ, melody_dim=53)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jp.init(k, jcodec_params))(
        jax.random.PRNGKey(1)))
    tp_ = JascoConditioningProvider.from_dict({
        'description': LUTConditioner(n_bins=64, dim=8, output_dim=8, tokenizer='whitespace'),
        'chords': ChordsEmbConditioner(card=194, out_dim=8),
        'melody': MelodyConditioner(card=53, out_dim=8),
        'self_wav': DrumsConditioner(feat_extractor=tcodec, out_dim=8, **kw)},
        sequence_length=SEQ, melody_dim=53).eval()
    tp_.load_state_dict(conditioners_state_from_jax(tp_, params), strict=True)
    return jp, params, tp_


def _attributes(n_chords: int, n_melody: int, samples: int, cls=(ConditioningAttributes,
                                                                   SymbolicCondition,
                                                                   WavCondition)):
    attrs_cls, sym_cls, wav_cls = cls
    out = []
    for i in range(2):
        rng = np.random.RandomState(10 + i)
        a = attrs_cls(text={'description': ['drum n bass', None][i]})
        a.symbolic['chords'] = sym_cls(frame_chords=rng.randint(0, 194, (n_chords,)))
        a.symbolic['melody'] = sym_cls(melody=rng.rand(53, n_melody).astype(np.float32))
        a.wav['self_wav'] = wav_cls(
            wav=rng.randn(1, 1, samples).astype(np.float32) * 0.1, length=np.asarray([samples]),
            sample_rate=[32000], path=[None], seek_time=[None])
        out.append(a)
    return out


_JAX_CLS = (JaxAttributes, JaxSymbolic, JaxWav)


@pytest.mark.parametrize('n_chords,n_melody', [(SEQ - 7, SEQ + 9), (SEQ + 3, SEQ - 5)])
def test_provider_tokenize_pads_like_jax(provider_pair, n_chords, n_melody):
    """Chords padded with the null chord or cut, melodies zero-padded or cut
    to ``sequence_length``, as JAX's provider pads them."""
    jp, _, tp_ = provider_pair
    ours = tp_.tokenize(_attributes(n_chords, n_melody, 8000))
    ref = jp.tokenize(_attributes(n_chords, n_melody, 8000, _JAX_CLS))
    assert set(ours) == set(ref)
    np.testing.assert_array_equal(ours['chords'].frame_chords, ref['chords'].frame_chords)
    np.testing.assert_array_equal(ours['melody'].melody, ref['melody'].melody)
    np.testing.assert_array_equal(ours['self_wav'].wav, np.asarray(ref['self_wav'].wav))
    for a, b in zip(ours['description'], ref['description']):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ours['chords'].frame_chords.shape == (2, SEQ)
    if n_chords < SEQ:
        assert (ours['chords'].frame_chords[:, n_chords:] == 194).all()


def test_provider_conditions_match_jax(provider_pair):
    """Every condition within 1e-5 of its largest value: the text, the
    chords (the null chord included), the melody and the drums, whose
    codec encode and first-codebook latent run on each side."""
    jp, params, tp_ = provider_pair
    attrs = _attributes(SEQ - 4, SEQ + 2, 16000)
    ours = tp_(tp_.tokenize(attrs))
    ref = jax.jit(jp.__call__)(params, jp.tokenize(_attributes(SEQ - 4, SEQ + 2, 16000,
                                                               _JAX_CLS)))
    assert set(ours) == set(ref) == {'description', 'chords', 'melody', 'self_wav'}
    for name in ours:
        assert ours[name][0].shape == ref[name][0].shape, name
        assert _rel(ours[name][0], ref[name][0]) < 1e-5, name
        np.testing.assert_array_equal(ours[name][1].numpy(), np.asarray(ref[name][1]))


def test_drums_codes_and_latents_match_jax(codec_pair, provider_pair):
    """The drums path on the debug codec: the codes equal JAX's and spread
    over the codebook, and the first codebook's latent equals JAX's."""
    jcodec, jparams, tcodec = codec_pair
    wav = np.random.RandomState(6).randn(2, 1, 16000).astype(np.float32) * 0.1
    codes, _ = tcodec.encode(torch.from_numpy(wav))
    ref_codes, _ = jax.jit(jcodec.encode)(jparams, jnp.asarray(wav))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    assert len(np.unique(codes.numpy()[:, 0])) > 5
    lat = tcodec.decode_latent(codes[:, :1])
    ref_lat = jax.jit(jcodec.decode_latent)(jparams, ref_codes[:, :1])
    assert _rel(lat, ref_lat) < 1e-6


def test_nullified_drums_give_the_projection_bias(provider_pair):
    jp, params, tp_ = provider_pair
    null = WavCondition(np.zeros((2, 1, 1), np.float32), np.zeros(2), [32000] * 2,
                        [None] * 2, [None] * 2)
    out, mask = tp_.conditioners['self_wav'](null)
    ref, _ = jp.as_dict['self_wav'](params['self_wav'], JaxWav(*null))
    assert out.shape == (2, 1, 8) and mask.dtype == torch.int32
    assert _rel(out, ref) < 1e-6


@pytest.mark.parametrize('frames', [7, 8, 9, 10])
def test_temporal_blur_matches_jax(codec_pair, frames):
    """Spans of 3 frames averaged, the last padded by the mirrored tail."""
    jcodec = codec_pair[0]
    z = np.random.RandomState(frames).randn(2, frames, 5).astype(np.float32)
    ref = JaxDrums(feat_extractor=jcodec, out_dim=4)._temporal_blur(jnp.asarray(z))
    ours = DrumsConditioner(codec_pair[2], out_dim=4)._temporal_blur(torch.from_numpy(z))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_drums_tokenize_runs_the_stem_hook_on_real_wavs_only(codec_pair):
    drums = DrumsConditioner(codec_pair[2], out_dim=4)
    calls = []

    def stem_fn(wav):
        calls.append(wav.shape)
        return np.asarray(wav) * 0

    wav = WavCondition(np.ones((1, 1, 100), np.float32), np.array([100]), [32000])
    assert not drums.tokenize(wav, stem_fn=stem_fn).wav.any()
    null = WavCondition(np.ones((1, 1, 1), np.float32), np.array([0]), [32000])
    assert drums.tokenize(null, stem_fn=stem_fn).wav.all()
    assert calls == [(1, 1, 100)]


def test_load_jasco_from_jax_carries_the_whole_model(flow_pair, provider_pair, codec_pair):
    """``load_jasco_from_jax`` loads the flow model, the provider and the
    drums' codec strictly."""
    jm, fparams, tm = flow_pair
    _, cparams, tp_ = provider_pair
    model = FlowMatchingModel(ConditionFuser.from_dict({'cross': ('description',)}),
                              generator=torch.Generator().manual_seed(9), **WIDTHS)
    codec = builders.get_debug_compression_model(32000, device='cpu', seed=4)
    provider = JascoConditioningProvider.from_dict(
        {name: (DrumsConditioner(codec, out_dim=8, compression_model_latent_dim=32)
                if name == 'self_wav' else type(cond)(**_ctor(cond)))
         for name, cond in tp_.conditioners.items()}, sequence_length=SEQ)
    load_jasco_from_jax(model, provider, fparams, cparams)
    for a, b in ((model, tm), (provider, tp_), (codec, codec_pair[2])):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def _ctor(cond):
    if isinstance(cond, LUTConditioner):
        return dict(n_bins=cond.n_bins, dim=cond.dim, output_dim=cond.output_dim)
    return dict(card=cond.card, out_dim=cond.out_dim)


def test_get_jasco_model_matches_jax_builder():
    """``get_jasco_model(device='cpu')``: the flow model's and the
    provider's state dicts have the keys and shapes that JAX's builder's
    params carry to (the provider's T5 included), and the defaults' wiring."""
    model, provider, codec = builders.get_jasco_model(device='cpu')
    jm, jp, jcodec = jax_builders.get_jasco_model()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda k: (jm.init(k), jp.init(k, jcodec.init(k))), key)
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    for mapped, ours in ((flow_matching_state_from_jax(model, zeros[0]), model.state_dict()),
                         (conditioners_state_from_jax(provider, zeros[1]),
                          provider.state_dict())):
        assert {k: tuple(v.shape) for k, v in mapped.items()} == \
            {k: tuple(v.shape) for k, v in ours.items()}
    assert encodec_state_from_jax(codec, zeros[1]['self_wav']['codec']).keys() == \
        codec.state_dict().keys()
    assert provider.sequence_length == 500 and model.input_dim == 128 + 3 * 16
    assert model.fuser.fuse2cond == {'cross': ('description',)}
    assert provider.conditioners['self_wav'].feat_extractor is codec
    assert all(layer.self_attn.attn_kernel == 'auto' for layer in model.transformer.layers)
