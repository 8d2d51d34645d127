"""The port's transformer LM against the JAX package, on the CPU.

Weights come from the JAX package's init (or the reference debug LM state
dict in tests/goldens) and reach the port through ``ckpt/from_jax.py``;
inputs are made from a seed with numpy.  Tolerances: 1e-5 at small widths,
where both sides compute in fp32 and only the order of the sums differs;
1e-4 at the published MAGNeT-small widths (dim 1024, 16 heads, card 2048),
where the sums are 64x longer.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.builders import get_magnet_lm as jax_get_magnet_lm
from audiocraft_tpu.ckpt.torch_import import import_conditioners, import_lm, import_t5
from audiocraft_tpu.cond.conditioners import ConditioningProvider as JaxProvider
from audiocraft_tpu.cond.conditioners import LUTConditioner as JaxLUT
from audiocraft_tpu.cond.conditioners import T5Conditioner as JaxT5Conditioner
from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
from audiocraft_tpu.lm.model import LMModel as JaxLM
from audiocraft_tpu.nn.t5 import T5EncoderConfig as JaxT5Config
from audiocraft_tpu.patterns import DelayedPatternProvider
from audiocraft_tpu_torch.ckpt.from_jax import (conditioners_state_from_jax,
                                                lm_state_from_jax, t5_state_from_jax)
from audiocraft_tpu_torch.cond.conditioners import ConditioningProvider, LUTConditioner
from audiocraft_tpu_torch.cond.conditioners import T5Conditioner
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.lm.magnet import MagnetLMModel
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.nn.t5 import T5EncoderConfig

GOLDENS = Path(__file__).parent / "goldens"
FUSE = {'cross': ('description',)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0, **cfg):
    """A JAX LM with its params and a port LM holding the same weights."""
    jlm = JaxLM(pattern_provider=DelayedPatternProvider(cfg.get('n_q', 4)),
                fuser=JaxFuser.from_dict(FUSE), **cfg)
    params = _np_tree(jlm.init(jax.random.PRNGKey(seed)))
    tlm = LMModel(ConditionFuser.from_dict(FUSE), **cfg).eval()
    tlm.load_state_dict(lm_state_from_jax(tlm, params), strict=True)
    return jlm, params, tlm


def _inputs(B, K, S, card, cond_t, dim, seed):
    rng = np.random.RandomState(seed)
    seq = rng.randint(0, card + 1, (B, K, S)).astype(np.int32)   # mask id included
    cond = rng.randn(B, cond_t, dim).astype(np.float32)
    mask = np.ones((B, cond_t), np.int32)
    mask[-1, cond_t // 2:] = 0
    cond = (cond * mask[..., None]).astype(np.float32)
    return seq, cond, mask


def _forward_both(jlm, params, tlm, seq, cond, mask, attn_mask=None):
    jc = {'description': (jnp.asarray(cond), jnp.asarray(mask))}
    ref, _ = jlm.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(seq), jc,
                         attn_mask=None if attn_mask is None else jnp.asarray(attn_mask))
    tc = {'description': (torch.from_numpy(cond), torch.from_numpy(mask))}
    with torch.no_grad():
        out = tlm(torch.from_numpy(seq), tc,
                  attn_mask=None if attn_mask is None else torch.from_numpy(attn_mask))
    return out, np.asarray(ref)


@pytest.mark.parametrize("norm_first,activation,causal,attn_kernel,extra", [
    (True, 'gelu', False, 'auto', {}),
    (True, 'gelu', True, True, {}),
    (False, 'relu', True, False, {}),
    (False, 'gelu', False, False, {}),
    (True, 'relu', True, False, dict(past_context=3, layer_scale=0.3)),
    (True, 'gelu', False, 'auto', dict(qk_layer_norm=True, bias_proj=False, bias_ff=False,
                                       bias_attn=False, weight_init='gaussian')),
])
def test_lm_forward_matches_jax(norm_first, activation, causal, attn_kernel, extra):
    cfg = dict(n_q=4, card=50, dim=32, num_heads=4, num_layers=2, cross_attention=True,
               norm_first=norm_first, activation=activation, causal=causal,
               attn_kernel=attn_kernel, **extra)
    jlm, params, tlm = _pair(seed=len(extra) + causal, **cfg)
    seq, cond, mask = _inputs(2, 4, 11, 50, 5, 32, seed=1)
    out, ref = _forward_both(jlm, params, tlm, seq, cond, mask)
    assert out.shape == (2, 4, 11, 50) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_banded_mask_forward_matches_jax():
    """A MAGNeT stage > 0 forward: the restricted-context mask, plain path."""
    cfg = dict(n_q=4, card=50, dim=32, num_heads=4, num_layers=2, cross_attention=True,
               norm_first=True, causal=False, attn_kernel='auto')
    jlm, params, tlm = _pair(seed=3, **cfg)
    seq, cond, mask = _inputs(2, 4, 12, 50, 5, 32, seed=2)
    band = np.abs(np.arange(12)[:, None] - np.arange(12)[None, :]) <= 5
    attn_mask = np.where(band, 0.0, -np.inf).astype(np.float32)[None, None]
    out, ref = _forward_both(jlm, params, tlm, seq, cond, mask, attn_mask)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_stage0_forward_at_magnet_small_widths():
    """MAGNeT-small's widths (dim 1024, 16 heads, card 2048, its
    flags), depth cut to 2 layers: a stage-0 forward with no mask."""
    jlm_full, _ = jax_get_magnet_lm('small', segment_duration=30)
    jlm = dataclasses.replace(jlm_full, num_layers=2)
    params = _np_tree(jlm.init(jax.random.PRNGKey(4)))
    tlm = MagnetLMModel(
        ConditionFuser.from_dict(FUSE), n_q=4, card=2048, dim=1024, num_heads=16,
        num_layers=2, hidden_scale=4, norm_first=True, bias_proj=False, bias_ff=False,
        bias_attn=False, cross_attention=True, causal=False, weight_init='gaussian',
        attn_kernel='auto').eval()
    tlm.load_state_dict(lm_state_from_jax(tlm, params), strict=True)
    rng = np.random.RandomState(5)
    B, S = 2, 30
    seq = np.full((B, 4, S), 2048, np.int32)
    keep = rng.rand(B, 4, S) < 0.25
    seq[keep] = rng.randint(0, 2048, int(keep.sum()))
    cond = rng.randn(B, 6, 1024).astype(np.float32)
    out, ref = _forward_both(jlm, params, tlm, seq, cond, np.ones((B, 6), np.int32))
    assert out.shape == (B, 4, S, 2048)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def _golden_lm():
    data = np.load(GOLDENS / "debug_lm_state.npz")
    sd = {k: data[k] for k in data.files}
    cfg = dict(n_q=4, card=60, dim=16, num_heads=4, num_layers=2, cross_attention=True,
               causal=True, norm_first=False, activation='relu')
    return sd, cfg


def test_reference_debug_lm_state_loads_strict_and_matches_jax():
    sd, cfg = _golden_lm()
    tlm = LMModel(ConditionFuser.from_dict(FUSE), **cfg).eval()
    tlm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    jlm = JaxLM(pattern_provider=DelayedPatternProvider(4), fuser=JaxFuser.from_dict(FUSE),
                **cfg)
    params = import_lm(jlm, sd)
    seq, cond, mask = _inputs(3, 4, 10, 60, 5, 16, seed=7)
    out, ref = _forward_both(jlm, params, tlm, seq, cond, mask)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _numpy_sd(module, prefix=''):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


def test_lm_state_round_trips_through_import_lm():
    cfg = dict(n_q=4, card=50, dim=32, num_heads=4, num_layers=2, cross_attention=True,
               norm_first=True, causal=False, layer_scale=0.2, qk_layer_norm=True)
    jlm, params, tlm = _pair(seed=9, **cfg)
    _assert_trees_equal(import_lm(jlm, _numpy_sd(tlm)), params)
    sd, gcfg = _golden_lm()     # and the reference state dict comes back unchanged
    golden = LMModel(ConditionFuser.from_dict(FUSE), **gcfg)
    golden.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    back = _numpy_sd(golden)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])


def test_conditioner_and_t5_states_round_trip():
    t5_cfg = dict(vocab_size=300, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4)
    jprov = JaxProvider.from_dict({
        'description': JaxT5Conditioner(name='t5-base', output_dim=24,
                                        config=JaxT5Config(**t5_cfg)),
        'genre': JaxLUT(n_bins=40, dim=12, output_dim=24)})
    params = _np_tree(jprov.init(jax.random.PRNGKey(2)))
    tprov = ConditioningProvider.from_dict({
        'description': T5Conditioner(name='t5-base', output_dim=24,
                                     config=T5EncoderConfig(**t5_cfg)),
        'genre': LUTConditioner(n_bins=40, dim=12, output_dim=24)})
    tprov.load_state_dict(conditioners_state_from_jax(tprov, params), strict=True)
    sd = _numpy_sd(tprov, prefix='condition_provider.')
    back = import_conditioners(jprov, sd)
    for name in ('description', 'genre'):
        expect = {k: v for k, v in params[name].items() if k != 't5'}
        _assert_trees_equal(back[name], expect)
    t5_sd = _numpy_sd(tprov.conditioners['description'].t5)
    _assert_trees_equal(import_t5(t5_sd, 2), params['description']['t5'])
    assert t5_state_from_jax(params['description']['t5']).keys() == t5_sd.keys()
