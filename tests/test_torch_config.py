"""The port's reference-config bridge (``config.py``) against the JAX
package's, and the fields that it needs of the port's modules, on the CPU.

The reference config dicts are those of ``tests/test_config_bridge.py``
(copied here): the published facebook/encodec_32khz and musicgen-small
exports, and the melody, MAGNeT and style variants of the latter.  The port
builds them on the meta device (no weights drawn); its config, as
``ckpt/io.config_to_dict`` writes it, must equal the JAX model's as the JAX
package writes it, and ``diff_models`` against the port's builders must be
empty.  ``disable_norm_outer_blocks`` is held against JAX's SEANet in fp32
at 1e-5.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu import config as jax_config
from audiocraft_tpu.ckpt import io as jax_io
from audiocraft_tpu.ckpt import torch_import as jax_import
from audiocraft_tpu.lm.model import LMModel as JaxLM
from audiocraft_tpu.nn import seanet as jax_seanet
from audiocraft_tpu_torch import builders, config
from audiocraft_tpu_torch.ckpt import io
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.nn import init
from audiocraft_tpu_torch.nn.seanet import SEANetDecoder, SEANetEncoder
from audiocraft_tpu_torch.ops.seanet import encoder_stage_plan
from audiocraft_tpu_torch.quant.base import DummyQuantizer


def encodec_32khz_cfg():
    return {
        'compression_model': 'encodec',
        'device': 'cuda', 'dtype': 'float32',
        'encodec': {'autoencoder': 'seanet', 'quantizer': 'rvq',
                    'sample_rate': 32000, 'channels': 1, 'causal': False,
                    'renormalize': False},
        'seanet': {
            'dimension': 128, 'channels': 1, 'causal': False,
            'n_filters': 64, 'n_residual_layers': 1, 'ratios': [8, 5, 4, 4],
            'activation': 'ELU', 'activation_params': {'alpha': 1.0},
            'norm': 'weight_norm', 'norm_params': {},
            'kernel_size': 7, 'residual_kernel_size': 3,
            'last_kernel_size': 7, 'dilation_base': 2, 'pad_mode': 'reflect',
            'true_skip': True, 'compress': 2, 'lstm': 2,
            'disable_norm_outer_blocks': 0,
            'encoder': {},
            'decoder': {'trim_right_ratio': 1.0, 'final_activation': None,
                        'final_activation_params': None},
        },
        'rvq': {'n_q': 4, 'q_dropout': False, 'bins': 2048, 'decay': 0.99,
                'kmeans_init': True, 'kmeans_iters': 10,
                'threshold_ema_dead_code': 2.0,
                'orthogonal_reg_weight': 0.0,
                'orthogonal_reg_active_codes_only': False,
                'orthogonal_reg_max_codes': None},
    }


def musicgen_small_cfg():
    return {
        'lm_model': 'transformer_lm',
        'device': 'cuda', 'dtype': 'float16',
        'transformer_lm': {
            'dim': 1024, 'num_heads': 16, 'num_layers': 24,
            'hidden_scale': 4, 'n_q': 4, 'card': 2048,
            'dropout': 0.0, 'emb_lr': None, 'activation': 'gelu',
            'norm_first': True, 'bias_ff': False, 'bias_attn': False,
            'bias_proj': False, 'past_context': None, 'causal': True,
            'custom': False, 'memory_efficient': True,
            'attention_as_float32': False, 'positional_embedding': 'sin',
            'xpos': False, 'checkpointing': 'none', 'weight_init': 'gaussian',
            'depthwise_init': 'current', 'zero_bias_init': True,
            'norm': 'layer_norm', 'cross_attention': False,
            'qk_layer_norm': False, 'qk_layer_norm_cross': False,
            'attention_dropout': None, 'kv_repeat': 1,
            'two_step_cfg': False, 'q_modeling': None,
        },
        'codebooks_pattern': {
            'modeling': 'delay',
            'delay': {'delays': [0, 1, 2, 3], 'flatten_first': 0,
                      'empty_initial': 0},
        },
        'conditioners': {
            'args': {'merge_text_conditions_p': 0.25, 'drop_desc_p': 0.5},
            'description': {'model': 't5',
                            't5': {'name': 't5-base', 'finetune': False,
                                   'word_dropout': 0.3,
                                   'normalize_text': False}},
        },
        'fuser': {'cross_attention_pos_emb': False,
                  'cross_attention_pos_emb_scale': 1.0,
                  'sum': [], 'prepend': [], 'cross': ['description'],
                  'input_interpolate': []},
        'classifier_free_guidance': {'training_dropout': 0.3,
                                     'inference_coef': 3.0},
        'attribute_dropout': {'args': {'active_on_eval': False},
                              'text': {}, 'wav': {'self_wav': 1.0}},
        'dataset': {'segment_duration': 30},
    }


def melody_cfg():
    cfg = musicgen_small_cfg()
    cfg['conditioners']['self_wav'] = {
        'model': 'chroma_stem',
        'chroma_stem': {'sample_rate': 32000, 'n_chroma': 12, 'radix2_exp': 12, 'argmax': True,
                        'match_len_on_eval': True, 'cache_path': None, 'eval_wavs': None,
                        'n_eval_wavs': 100}}
    cfg['fuser']['prepend'] = ['self_wav']
    return cfg


def magnet_cfg():
    cfg = musicgen_small_cfg()
    cfg['lm_model'] = 'transformer_lm_magnet'
    cfg['transformer_lm'].update(subcodes_context=5, causal=False)
    cfg['codebooks_pattern'] = {'modeling': 'parallel', 'parallel': {}}
    cfg['masking'] = {'span_len': 3}
    cfg['dataset'] = {'segment_duration': 10}
    return cfg


def style_cfg():
    cfg = musicgen_small_cfg()
    cfg['conditioners']['self_wav'] = {
        'model': 'style',
        'style': {'model_name': 'mert', 'transformer_scale': 'default', 'sample_rate': 32000,
                  'encodec_n_q': 4, 'length': 3.0, 'ds_factor': 15, 'n_q_out': 6,
                  'eval_q': 3, 'q_dropout': True, 'bins': 1024,
                  'varying_lengths': [1.5, 4.5], 'batch_norm': True,
                  'rvq_threshold_ema_dead_code': 0.1, 'use_middle_of_segment': False,
                  'ds_rate_compression': 640, 'num_codebooks_lm': 4}}
    cfg['fuser']['prepend'] = ['self_wav']
    return cfg


LM_CASES = {
    'small': (musicgen_small_cfg, lambda **kw: builders.get_musicgen_lm('small', **kw)),
    'melody': (melody_cfg, lambda **kw: builders.get_musicgen_lm('small', melody=True, **kw)),
    'magnet': (magnet_cfg, lambda **kw: builders.get_magnet_lm('small', **kw)),
    'style': (style_cfg, lambda **kw: builders.get_musicgen_lm('small', style=True, **kw)),
}


def _meta(build, *args, **kw):
    """``build`` on the meta device: the modules and their config, no weights."""
    with init.allocate_only('meta'):
        return build(*args, device='meta', **kw)


def _reports_equal(ours, theirs):
    assert ours.unknown == theirs.unknown
    assert ours.runtime == theirs.runtime
    assert ours.training_only == theirs.training_only


def test_32khz_cfg_matches_the_builder_and_jax():
    model, report = _meta(config.compression_model_from_cfg, encodec_32khz_cfg(),
                          compute_dtype='bfloat16')
    jmodel, jreport = jax_config.compression_model_from_cfg(encodec_32khz_cfg(),
                                                            compute_dtype='bfloat16')
    _reports_equal(report, jreport)
    assert report.unknown == {}
    assert config.diff_models(model, _meta(builders.get_encodec_32khz)) == []
    assert io.config_to_dict(model) == jax_io.config_to_dict(jmodel)
    assert model.frame_rate == 50 and model.sample_rate == 32000


@pytest.mark.parametrize('case', sorted(LM_CASES))
def test_lm_cfg_matches_the_builder_and_jax(case):
    make_cfg, build = LM_CASES[case]
    lm, provider, report = _meta(config.lm_from_cfg, make_cfg())
    jlm, jprovider, jreport = jax_config.lm_from_cfg(make_cfg())
    _reports_equal(report, jreport)
    assert report.unknown == {}
    assert 'classifier_free_guidance.training_dropout' in report.training_only
    assert 'transformer_lm.memory_efficient' in report.runtime
    fb_lm, fb_provider = _meta(build)
    assert config.diff_models(lm, fb_lm) == []
    assert config.diff_models(provider, fb_provider) == []
    ours = io.config_to_dict({'lm': lm, 'condition_provider': provider})
    assert ours == jax_io.config_to_dict({'lm': jlm, 'condition_provider': jprovider})


def test_unknown_keys_reported_and_strict_raises_as_in_jax():
    cfg = musicgen_small_cfg()
    cfg['transformer_lm']['mystery_knob'] = 7
    cfg['conditioners']['description']['t5']['odd'] = 1
    _, _, report = _meta(config.lm_from_cfg, cfg)
    _, _, jreport = jax_config.lm_from_cfg(cfg)
    _reports_equal(report, jreport)
    assert report.unknown == {'transformer_lm.mystery_knob': 7,
                              'conditioners.description.t5.odd': 1}
    with pytest.raises(ValueError, match='mystery_knob'):
        _meta(config.lm_from_cfg, cfg, strict=True)
    with pytest.raises(ValueError, match='mystery_knob'):
        jax_config.lm_from_cfg(cfg, strict=True)
    codec_cfg = encodec_32khz_cfg()
    codec_cfg['rvq']['orthogonal_reg_max_codes'] = 64
    codec_cfg['seanet']['norm_params'] = {'eps': 1e-3}
    _, report = _meta(config.compression_model_from_cfg, codec_cfg)
    _, jreport = jax_config.compression_model_from_cfg(codec_cfg)
    _reports_equal(report, jreport)
    with pytest.raises(ValueError, match='orthogonal_reg_max_codes'):
        _meta(config.compression_model_from_cfg, codec_cfg, strict=True)


def test_cfg_diff_reports_drift():
    cfg = encodec_32khz_cfg()
    cfg['seanet']['n_filters'] = 32
    cfg['rvq']['bins'] = 1024
    model, _ = _meta(config.compression_model_from_cfg, cfg, compute_dtype='bfloat16')
    delta = config.diff_models(model, _meta(builders.get_encodec_32khz))
    assert len(delta) == 3, delta
    assert 'encoder.n_filters: 32 != 64' in delta and 'quantizer.bins: 1024 != 2048' in delta


def test_no_quant_builds_the_dummy_quantizer():
    cfg = encodec_32khz_cfg()
    cfg['encodec']['quantizer'] = 'no_quant'
    model, _ = config.compression_model_from_cfg(
        {**cfg, 'seanet': {**cfg['seanet'], 'n_filters': 2, 'lstm': 0}}, device='cpu')
    assert isinstance(model.quantizer, DummyQuantizer) and model.quantizer.dimension == 128
    x = torch.randn(1, 1, 640 * 3)
    codes, _ = model.encode(x)
    assert codes.shape == (1, 1, 128, 3) and codes.is_floating_point()


def test_refused_values_raise():
    cfg = encodec_32khz_cfg()
    cfg['rvq']['orthogonal_reg_weight'] = 0.1
    with pytest.raises(ValueError, match='orthogonal_reg_weight'):
        _meta(config.compression_model_from_cfg, cfg)
    with pytest.raises(ValueError, match='disable_norm_outer_blocks'):
        SEANetEncoder(ratios=(2,), disable_norm_outer_blocks=4)


def test_uniform_weight_init_stays_in_bounds_with_jax_shapes():
    """'uniform' draws the embeddings and heads uniformly in +-sqrt(3) std,
    std = 1/sqrt(dim), as JAX's init does; the draws differ by design."""
    kw = dict(n_q=2, card=50, dim=48, num_heads=4, num_layers=1, weight_init='uniform')
    lm = LMModel(ConditionFuser({}), **kw)
    jparams = JaxLM(pattern_provider=None, fuser=None, **kw).init(jax.random.PRNGKey(0))
    bound = np.sqrt(3.0) / np.sqrt(48)
    emb = torch.stack([e.weight for e in lm.emb]).numpy()
    heads = torch.stack([h.weight for h in lm.linears]).numpy()
    assert emb.shape == jparams['emb'].shape and heads.shape == jparams['linears']['weight'].shape
    for w in (emb, heads, np.asarray(jparams['emb']), np.asarray(jparams['linears']['weight'])):
        assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
        assert abs(float(w.std()) - 1 / np.sqrt(48)) < 0.1 / np.sqrt(48)


SMALL_SEANET = dict(channels=1, dimension=8, n_filters=4, n_residual_layers=1, ratios=(4, 2),
                    norm='time_group_norm', lstm=0)


@pytest.mark.parametrize('disable', [0, 1, 4])
@pytest.mark.parametrize('side', ['encoder', 'decoder'])
def test_disable_norm_outer_blocks_matches_jax(side, disable):
    """With ``norm='time_group_norm'`` the outer blocks' norms go as JAX's
    block counting drops them (n_blocks = 4 here): the same weights (the
    port's, through JAX's importer, the norms' affine made random) give the
    same output in fp32 within 1e-5."""
    port_cls, jax_cls = {'encoder': (SEANetEncoder, jax_seanet.SEANetEncoder),
                         'decoder': (SEANetDecoder, jax_seanet.SEANetDecoder)}[side]
    stack = port_cls(**SMALL_SEANET, disable_norm_outer_blocks=disable).eval()
    jstack = jax_cls(**SMALL_SEANET, disable_norm_outer_blocks=disable)
    rng = np.random.RandomState(disable)
    sd = {k: (v.numpy() + rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
              if '.norm.' in k else v.numpy()) for k, v in stack.state_dict().items()}
    n_norms = sum('.norm.weight' in k for k in sd)
    # 8 convs with a norm in the encoder, 6 in the decoder (transposed convs take none)
    assert n_norms == {'encoder': {0: 8, 1: 7, 4: 0}, 'decoder': {0: 6, 1: 5, 4: 0}}[side][disable]
    stack.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params = jax.tree.map(jnp.asarray, jax_import.import_seanet(jstack, sd))
    x = np.random.RandomState(5).randn(2, 1 if side == 'encoder' else 8,
                                       256 if side == 'encoder' else 32).astype(np.float32)
    with torch.no_grad():
        ours = stack(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jax.jit(jstack.__call__)(params, jnp.asarray(x)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)


def test_stage_plan_fuses_no_norm_that_is_not_there():
    """The fused encoder route plans no stage of a GroupNorm stack, whatever
    its outer blocks drop; a weight-norm stack plans its stages whatever
    ``disable_norm_outer_blocks`` says (weight norm is folded into the
    weights, so the graph is the same)."""
    gn = dict(n_filters=4, n_residual_layers=1, ratios=(4, 2), norm='time_group_norm')
    for disable in (0, 1, 4):
        assert encoder_stage_plan(SEANetEncoder(**gn, disable_norm_outer_blocks=disable)) == []
    wn = dict(gn, norm='weight_norm')
    plans = [encoder_stage_plan(SEANetEncoder(**wn, disable_norm_outer_blocks=d)) for d in (0, 4)]
    assert plans[0] and plans[0] == plans[1]


def test_fuser_and_provider_accept_the_jax_pair_form():
    fuser = ConditionFuser((('cross', ('description',)), ('prepend', ('self_wav',))))
    assert fuser.fuse2cond == {'cross': ('description',), 'prepend': ('self_wav',)}
    lm, provider = builders.get_debug_musicgen_lm(device='cpu')
    rebuilt = io.config_from_dict(copy.deepcopy(io.config_to_dict(provider)))
    assert list(rebuilt.conditioners) == ['description']
    assert config.diff_models(rebuilt, provider) == []
