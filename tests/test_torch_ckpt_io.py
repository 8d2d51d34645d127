"""Checkpoint directories (``ckpt/io.py``) and the pretrained-model loaders
(``ckpt/loaders.py``) against the JAX package, on the CPU.

Directories the JAX package's ``save_checkpoint`` writes load through the
port's ``get_pretrained`` / ``load_checkpoint``: the JAX params come from the
port's seeded debug modules through JAX's own importers (JAX's eager init
takes about 15 s a facade here).  Codes and fp32 greedy tokens compare
exactly, logits within 1e-5, the style conditioner's output within 1e-4 of
its largest value (the style tests' bar).  The port's own directories
round-trip bit for bit, and the JAX package reads their ``config.json``.
"""

import copy
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu import builders as jax_builders
from audiocraft_tpu.ckpt import io as jax_io
from audiocraft_tpu.ckpt import torch_import as jax_import
from audiocraft_tpu.codec.stereo import InterleaveStereoCompressionModel as JaxStereo
from audiocraft_tpu.cond.attributes import WavCondition as JaxWavCondition
from audiocraft_tpu.cond.conditioners import ConditioningProvider as JaxProvider
from audiocraft_tpu.cond.conditioners import LUTConditioner as JaxLUT
from audiocraft_tpu.cond.style_cond import StyleConditioner as JaxStyle
from audiocraft_tpu.config import diff_models as jax_diff_models
from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.ckpt import io, loaders
from audiocraft_tpu_torch.codec.stereo import InterleaveStereoCompressionModel
from audiocraft_tpu_torch.cond.attributes import ConditioningAttributes, WavCondition
from audiocraft_tpu_torch.cond.conditioners import ConditioningProvider, LUTConditioner
from audiocraft_tpu_torch.cond.style_cond import StyleConditioner
from audiocraft_tpu_torch.nn import init

SR = 32000
STYLE = dict(output_dim=16, sample_rate=SR, encodec_n_q=2, length=0.5, transformer_scale='xsmall',
             ds_factor=2, n_q_out=4, eval_q=2, bins=64, use_middle_of_segment=True,
             num_codebooks_lm=4, ds_rate_compression=1280)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(module, prefix=''):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope='module')
def jax_written(tmp_path_factory):
    """The port's seeded debug codec, LM and LUT provider; the same weights
    as the JAX package's debug models' params; and the directory the JAX
    package's ``save_checkpoint`` writes of them."""
    codec = builders.get_debug_compression_model(32000, device='cpu', seed=3)
    lm, provider = builders.get_debug_musicgen_lm(device='cpu', seed=4)
    jcodec = jax_builders.get_debug_compression_model(32000)
    jlm, jprovider = jax_builders.get_debug_musicgen_lm()
    codec_params = jax_import.import_encodec(jcodec, _np(codec))
    lm_params = jax_import.import_lm(jlm, _np(lm))
    cond_params = jax_import.import_conditioners(jprovider, _np(provider, 'condition_provider.'))
    root = tmp_path_factory.mktemp('jax_written')
    jax_io.save_checkpoint(root / 'compression', jcodec, codec_params)
    jax_io.save_checkpoint(root / 'lm', {'lm': jlm, 'condition_provider': jprovider},
                           {'lm': lm_params, 'condition_provider': cond_params})
    jparams = jax.tree.map(jnp.asarray, (codec_params, lm_params, cond_params))
    return root, (codec, lm, provider), (jcodec, jlm, jprovider), jparams


def test_jax_written_musicgen_loads_with_jax_codes_tokens_and_logits(jax_written):
    root, (codec, lm, provider), (jcodec, jlm, jprovider), (jcp, jlp, jcondp) = jax_written
    mg = loaders.get_pretrained(str(root), device='cpu')
    for ours, original in ((mg.compression_model, codec), (mg.lm, lm),
                           (mg.condition_provider, provider)):
        assert io.config_to_dict(ours) == io.config_to_dict(original)
        for key, value in original.state_dict().items():
            assert torch.equal(ours.state_dict()[key], value), key

    wav = np.random.RandomState(1).randn(2, 1, 2 * SR).astype(np.float32) * 0.2
    codes, _ = mg.compression_model.encode(torch.from_numpy(wav))
    jcodes, _ = jax.jit(jcodec.encode)(jcp, jnp.asarray(wav))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))

    texts = ['a calm piano piece', 'drums']
    attrs = [ConditioningAttributes(text={'description': t}) for t in texts]
    cond = mg.condition_provider(mg.condition_provider.tokenize(attrs))['description']
    jcond = jprovider(jcondp, jprovider.tokenize(attrs))['description']
    np.testing.assert_allclose(cond[0].numpy(), np.asarray(jcond[0]), rtol=1e-6, atol=1e-6)

    seq = np.random.RandomState(2).randint(0, 400, (2, 4, 9))
    with torch.no_grad():
        logits = mg.lm(torch.from_numpy(seq), {'description': cond})
    jlogits, _ = jlm.forward(jlp, jnp.asarray(seq), {'description': jcond})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)

    null = (torch.zeros_like(cond[0]), torch.zeros_like(cond[1]))
    both = {'description': tuple(torch.cat([c, n]) for c, n in zip(cond, null))}
    tokens = mg.lm.generate(condition_tensors=both, num_samples=2, max_gen_len=8,
                            use_sampling=False, cfg_coef=3.0)
    jboth = {'description': tuple(jnp.asarray(t.numpy()) for t in both['description'])}
    jtokens = jlm.generate(jlp, jax.random.PRNGKey(0), condition_tensors=jboth,
                           num_samples=2, max_gen_len=8, use_sampling=False, cfg_coef=3.0)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))


def test_jax_written_stereo_codec(jax_written, tmp_path):
    root, (codec, _, _), (jcodec, _, _), (jcp, _, _) = jax_written
    jstereo = JaxStereo(model=jcodec)
    jax_io.save_checkpoint(tmp_path, jstereo, jax.tree.map(np.asarray, jcp))
    stereo, meta = io.load_checkpoint(tmp_path, device='cpu')
    assert isinstance(stereo, InterleaveStereoCompressionModel) and 'layout' not in meta
    wav = np.random.RandomState(3).randn(1, 2, SR).astype(np.float32) * 0.2
    codes, _ = stereo.encode(torch.from_numpy(wav))
    jcodes, _ = jax.jit(jstereo.encode)(jcp, jnp.asarray(wav))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))


def test_jax_written_style_lm_directory(jax_written, tmp_path):
    """An LM bundle whose provider holds a style conditioner: its weights and
    its own codec (the JAX params' ``codec``, which the reference hides from
    the state dict) load, and the conditioner's output is JAX's."""
    _, (codec, _, _), (jcodec, _, _), (jcp, _, _) = jax_written
    lm, _ = builders.get_debug_musicgen_lm(device='cpu', seed=5)
    provider = ConditioningProvider({
        'description': LUTConditioner(128, 16, 16, generator=torch.Generator().manual_seed(6)),
        'self_wav': StyleConditioner(feat_extractor=codec, **STYLE)}).eval()
    jlm, _ = jax_builders.get_debug_musicgen_lm()
    jprovider = JaxProvider.from_dict({
        'description': JaxLUT(n_bins=128, dim=16, output_dim=16),
        'self_wav': JaxStyle(feat_extractor=jcodec, **STYLE)})
    cond_params = jax_import.import_conditioners(jprovider, _np(provider, 'condition_provider.'))
    cond_params['self_wav']['codec'] = jax.tree.map(np.asarray, jcp)
    jax_io.save_checkpoint(tmp_path, {'lm': jlm, 'condition_provider': jprovider},
                           {'lm': jax_import.import_lm(jlm, _np(lm)),
                            'condition_provider': cond_params})
    bundle, _ = io.load_checkpoint(tmp_path, device='cpu')
    style = bundle['condition_provider'].conditioners['self_wav']
    assert isinstance(style, StyleConditioner)
    for ours, original in ((bundle['condition_provider'], provider),
                           (style.feat_extractor, codec), (bundle['lm'], lm)):
        for key, value in original.state_dict().items():
            assert torch.equal(ours.state_dict()[key], value), key
    wav = np.random.RandomState(4).randn(2, 1, SR).astype(np.float32) * 0.1
    x = WavCondition(wav, np.full(2, SR), [SR] * 2, [None] * 2, [None] * 2)
    out, mask = style(style.tokenize(x))
    jout, jmask = jax.jit(lambda p: jprovider.as_dict['self_wav'](p, JaxWavCondition(*x)))(
        jax.tree.map(jnp.asarray, cond_params['self_wav']))
    ref = np.asarray(jout)
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-4 * float(np.abs(ref).max())
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_port_directory_round_trips_and_jax_reads_its_config(tmp_path):
    codec = builders.get_debug_compression_model(32000, device='cpu', seed=7)
    lm, provider = builders.get_debug_musicgen_lm(device='cpu', seed=8)
    bundle = {'lm': lm, 'condition_provider': provider}
    io.save_checkpoint(tmp_path / 'compression', codec, extra={'note': 1})
    io.save_checkpoint(tmp_path / 'lm', bundle)
    for name, original in (('compression', codec), ('lm', bundle)):
        loaded, meta = io.load_checkpoint(tmp_path / name, device='cpu')
        assert meta['layout'] == io.LAYOUT
        assert io.config_to_dict(loaded) == io.config_to_dict(original)
        assert io.model_state(loaded).keys() == io.model_state(original).keys()
        for key, value in io.model_state(original).items():
            np.testing.assert_array_equal(io.model_state(loaded)[key], value, err_msg=key)
    assert json.loads((tmp_path / 'compression' / 'config.json').read_text())['extra'] == \
        {'note': 1}
    # the JAX package builds the same architecture from the port's config
    jcodec = jax_io.config_from_dict(json.loads(
        (tmp_path / 'compression' / 'config.json').read_text())['config'])
    assert jax_diff_models(jcodec, jax_builders.get_debug_compression_model(32000)) == []
    jbundle = jax_io.config_from_dict(json.loads(
        (tmp_path / 'lm' / 'config.json').read_text())['config'])
    jlm, jprovider = jax_builders.get_debug_musicgen_lm()
    assert jax_diff_models(jbundle['lm'], jlm) == []
    assert jax_diff_models(jbundle['condition_provider'], jprovider) == []
    # published widths too, built on the meta device
    with init.allocate_only('meta'):
        big_lm, big_provider = builders.get_musicgen_lm('small', style=True, device='meta')
        big_codec = builders.get_encodec_32khz(device='meta')
    jbig = jax_io.config_from_dict(copy.deepcopy(io.config_to_dict(
        {'lm': big_lm, 'condition_provider': big_provider, 'codec': big_codec})))
    jlm, jprovider = jax_builders.get_musicgen_lm('small', style=True)
    assert jax_diff_models(jbig['lm'], jlm) == []
    # JAX's diff_models compares its (eq=False) style conditioners by identity
    assert jax_io.config_to_dict(jbig['condition_provider']) == \
        jax_io.config_to_dict(jprovider)
    assert jax_diff_models(jbig['codec'], jax_builders.get_encodec_32khz()) == []


def test_resolve_and_list_local_models(tmp_path, monkeypatch):
    cache = tmp_path / 'cache'
    for sub in ('facebook--musicgen-small', 'musicgen-melody', 'mine'):
        (cache / sub / 'lm').mkdir(parents=True)
    (cache / 'not-a-model').mkdir()
    monkeypatch.setenv('AUDIOCRAFT_TPU_TORCH_CACHE_DIR', str(cache))
    assert loaders.get_cache_dir() == cache
    assert loaders.list_local_models() == ['debug', 'facebook--musicgen-small', 'mine',
                                           'musicgen-melody']
    assert loaders.resolve_checkpoint_dir('small') == cache / 'facebook--musicgen-small'
    assert loaders.resolve_checkpoint_dir('facebook/musicgen-melody') == cache / 'musicgen-melody'
    assert loaders.resolve_checkpoint_dir('melody') == cache / 'musicgen-melody'
    assert loaders.resolve_checkpoint_dir(str(cache / 'mine')) == cache / 'mine'
    assert loaders.resolve_checkpoint_dir('large') is None
    with pytest.raises(FileNotFoundError, match='import_checkpoint'):
        loaders.get_pretrained('large', device='cpu')
    with pytest.raises(FileNotFoundError, match='compression'):
        loaders.get_pretrained('mine', device='cpu')
    assert loaders.get_pretrained('debug', device='cpu').name == 'debug'


def test_load_model_keeps_the_two_most_recent(monkeypatch):
    built = []
    monkeypatch.setattr(loaders, 'get_pretrained',
                        lambda name, cache_dir=None, device=None: built.append(name) or name)
    loaders.clear_model_cache()
    for name in ('a', 'b', 'a', 'c', 'a', 'b'):
        assert loaders.load_model(name, device='cpu') == name
    # 'a' stayed recent throughout; 'b' was evicted by 'c' and built again
    assert built == ['a', 'b', 'c', 'b']
    assert [k[0] for k in loaders._MODEL_CACHE] == ['a', 'b']
    loaders.clear_model_cache()
    assert not loaders._MODEL_CACHE


@pytest.mark.parametrize('entry', ['get_pretrained', 'load_model', 'load_checkpoint',
                                   'compression_model_from_cfg', 'lm_from_cfg',
                                   'lm_from_hf_config', 'import_cli'])
def test_entry_points_refuse_to_fall_back_to_the_cpu(entry, monkeypatch, tmp_path):
    from audiocraft_tpu_torch import config
    from audiocraft_tpu_torch.apps import import_checkpoint
    from audiocraft_tpu_torch.ckpt import hf_import

    codec = builders.get_debug_compression_model(32000, device='cpu')
    io.save_checkpoint(tmp_path / 'c', codec)
    torch.save(codec.state_dict(), tmp_path / 'c.bin')
    loaders.clear_model_cache()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    calls = {
        'get_pretrained': lambda: loaders.get_pretrained('debug'),
        'load_model': lambda: loaders.load_model('debug'),
        'load_checkpoint': lambda: io.load_checkpoint(tmp_path / 'c'),
        'compression_model_from_cfg': lambda: config.compression_model_from_cfg({}),
        'lm_from_cfg': lambda: config.lm_from_cfg({'transformer_lm': {'dim': 16}}),
        'lm_from_hf_config': lambda: hf_import.lm_from_hf_config({}),
        'import_cli': lambda: import_checkpoint.main(
            ['compression', str(tmp_path / 'c.bin'), '--config', 'debug', '--out',
             str(tmp_path / 'out')]),
    }
    with pytest.raises(RuntimeError, match='CUDA'):
        calls[entry]()
