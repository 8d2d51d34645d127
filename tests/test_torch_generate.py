"""The port's cached decode and ``LMModel.generate`` against the JAX
package, on the CPU.

Weights come from the JAX package's init (or the reference debug LM state
dict in tests/goldens) and reach the port through ``ckpt/from_jax.py``;
inputs are made from a seed with numpy.  Greedy tokens compare exactly
(both packages take first-index argmaxes in fp32); logits and attention
outputs at 1e-5 (fp32, only the order of the sums differs), 1e-4 at the
published MusicGen-small widths, where the sums are 64x longer.  Sampled
tokens cannot compare with JAX (a torch.Generator is not a JAX key): they
compare with a cache-free reference loop that draws per step.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
from audiocraft_tpu.lm.model import LMModel as JaxLM
from audiocraft_tpu.lm.quantize import dequantize_weight as jax_dequantize_weight
from audiocraft_tpu.lm.quantize import quantize_lm_params as jax_quantize_lm_params
from audiocraft_tpu.nn.transformer import KVCache as JaxKVCache
from audiocraft_tpu.nn.transformer import StreamingMultiheadAttention as JaxMHA
from audiocraft_tpu.patterns import DelayedPatternProvider as JaxDelayed
from audiocraft_tpu_torch.ckpt.from_jax import lm_state_from_jax
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.lm import model as lm_model
from audiocraft_tpu_torch.lm import sampling
from audiocraft_tpu_torch.lm.decode import DecodeCache
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.lm.quantize import (dequantize_weight, pack_int4, quantize_lm_params,
                                              unpack_int4)
from audiocraft_tpu_torch.nn.transformer import (KVCache, QuantizedWeight,
                                                 StreamingMultiheadAttention, grow_cache)
from audiocraft_tpu_torch.patterns import DelayedPatternProvider

GOLDENS = Path(__file__).parent / "goldens"
FUSE = {'cross': ('description',)}
SMALL = dict(n_q=4, card=50, dim=32, num_heads=4, num_layers=2, cross_attention=True,
             causal=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0, **cfg):
    """A JAX LM with its params and a port LM holding the same weights."""
    jlm = JaxLM(pattern_provider=JaxDelayed(cfg['n_q']), fuser=JaxFuser.from_dict(FUSE), **cfg)
    params = _np_tree(jax.jit(jlm.init)(jax.random.PRNGKey(seed)))
    tlm = LMModel(ConditionFuser.from_dict(FUSE), pattern_provider=DelayedPatternProvider(
        cfg['n_q']), **cfg).eval()
    tlm.load_state_dict(lm_state_from_jax(tlm, params), strict=True)
    return jlm, params, tlm


@pytest.fixture(scope='module')
def small():
    return _pair(seed=0, norm_first=True, **SMALL)


def _conditions(rows, dim, seed, t=5):
    """Condition rows [rows, t, dim] with one row partly masked."""
    rng = np.random.RandomState(seed)
    cond = rng.randn(rows, t, dim).astype(np.float32)
    mask = np.ones((rows, t), np.int32)
    mask[-1, t // 2:] = 0
    return (cond * mask[..., None]).astype(np.float32), mask


def _both(cond, mask):
    return ({'description': (jnp.asarray(cond), jnp.asarray(mask))},
            {'description': (torch.from_numpy(cond), torch.from_numpy(mask))})


def _jax_generate(jlm, params, **kw):
    return np.asarray(jlm.generate(jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(0),
                                   **kw))


# ------------------------------------------------------------ cached decode
@pytest.mark.parametrize("past_context", [None, 3])
def test_streaming_decode_equals_the_batch_forward(past_context):
    """Sin positions continue at the cache index: a prefill of 4 steps then
    one step at a time gives the cache-free forward's logits."""
    cfg = dict(SMALL, past_context=past_context)
    _, _, tlm = _pair(seed=1, norm_first=False, **cfg)
    rng = np.random.RandomState(2)
    seq = torch.from_numpy(rng.randint(0, 51, (2, 4, 11)))
    cond, mask = _conditions(2, 32, seed=3)
    tcond = _both(cond, mask)[1]
    with torch.no_grad():
        full = tlm(seq, tcond)
        caches = tlm.init_cache(2, 16)
        cross_kv = tlm.transformer.precompute_cross_kv(tlm.cross_source(tcond, 2))
        steps = [tlm(seq[..., :4], tcond, cross_kv=cross_kv, caches=caches)]
        for t in range(4, 11):
            steps.append(tlm(seq[..., t:t + 1], tcond, cross_kv=cross_kv, caches=caches))
    assert int(caches[0].index) == 11 and all(c.index is caches[0].index for c in caches)
    np.testing.assert_allclose(torch.cat(steps, dim=2).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("past_context,quantized", [(None, False), (2, False), (None, True)])
def test_cached_attention_matches_jax(past_context, quantized):
    """One self-attention module with a cache of capacity 9: a prefill of 4
    then 3 single steps, against the JAX module on the same weights."""
    jmha = JaxMHA(embed_dim=32, num_heads=4, causal=True, past_context=past_context)
    params = _np_tree(jmha.init(jax.random.PRNGKey(4)))
    tmha = StreamingMultiheadAttention(32, 4, causal=True, past_context=past_context)
    tmha.load_state_dict({k: torch.tensor(v) for k, v in (
        ('in_proj_weight', params['in_proj_weight']), ('in_proj_bias', params['in_proj_bias']),
        ('out_proj.weight', params['out_proj']['weight']),
        ('out_proj.bias', params['out_proj']['bias']))})
    x = np.random.RandomState(5).randn(2, 7, 32).astype(np.float32)
    jcache = JaxKVCache.create(2, 9, 4, 8, quantized=quantized)
    tcache = KVCache.create(2, 9, 4, 8, quantized=quantized)
    for lo, hi in ((0, 4), (4, 5), (5, 6), (6, 7)):
        ref, jcache = jmha(jax.tree.map(jnp.asarray, params), jnp.asarray(x[:, lo:hi]),
                           cache=jcache)
        with torch.no_grad():
            out = tmha(torch.from_numpy(x[:, lo:hi]), cache=tcache)
        tcache.index += hi - lo
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert int(tcache.index) == int(jcache.index) == 7
    for ours, theirs in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-5)
    if quantized:
        np.testing.assert_allclose(tcache.k_scale.numpy(), np.asarray(jcache.k_scale),
                                   rtol=1e-6)


def test_grow_cache_pads_and_grows_in_place():
    caches = [KVCache.create(1, 3, 2, 4, quantized=q) for q in (False, True)]
    for c in caches:
        for t in c.tensors():
            t.fill_(1)
    grown = grow_cache(caches, 5)
    assert all(g.capacity == 5 and g.index is c.index for g, c in zip(grown, caches))
    assert grown[1].k.dtype == torch.int8 and float(grown[1].k_scale[:, 3:].abs().sum()) == 0
    out = [KVCache.create(1, 5, 2, 4, quantized=q, index=c.index)
           for q, c in zip((False, True), caches)]
    for t in out[0].tensors():
        t.fill_(7)
    into = grow_cache(caches, 5, out=out)
    assert into[0] is out[0]
    for g, o in zip(grown, out):
        for a, b in zip(g.tensors(), o.tensors()):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        grow_cache(caches, 2)


# -------------------------------------------------------------- generate
def test_greedy_tokens_equal_the_reference_golden():
    data = np.load(GOLDENS / "debug_lm_state.npz")
    cfg = dict(n_q=4, card=60, dim=16, num_heads=4, num_layers=2, cross_attention=True,
               causal=True, norm_first=False, activation='relu')
    tlm = LMModel(ConditionFuser.from_dict(FUSE), pattern_provider=DelayedPatternProvider(4),
                  **cfg).eval()
    tlm.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files}, strict=True)
    g = np.load(GOLDENS / "debug_lm_greedy.npz")
    tokens = tlm.generate(
        condition_tensors={'description': (torch.from_numpy(g['cond']),
                                           torch.from_numpy(g['mask']))},
        num_samples=2, max_gen_len=10, use_sampling=False, cfg_coef=3.0)
    np.testing.assert_array_equal(tokens.numpy(), g['tokens'])


@pytest.mark.parametrize("cfg_form,with_prompt", [
    ('one_pass', False), ('one_pass', True), ('two_step', False), ('double', True)])
def test_greedy_generate_equals_jax(small, cfg_form, with_prompt):
    jlm, params, tlm = small
    B = 2
    prompt = (np.random.RandomState(6).randint(0, 50, (B, 4, 5)).astype(np.int32)
              if with_prompt else None)
    kw = dict(num_samples=B, max_gen_len=14, use_sampling=False, cfg_coef=2.5,
              remove_prompts=with_prompt)
    if cfg_form == 'two_step':
        jc, tc = _both(*_conditions(B, 32, seed=7))
        jn, tn = _both(*_conditions(B, 32, seed=8))
        jcond, tcond = (jc, jn), (tc, tn)
    else:
        groups = {'one_pass': 2, 'double': 3}[cfg_form]
        jcond, tcond = _both(*_conditions(groups * B, 32, seed=9))
    if cfg_form == 'double':
        kw['cfg_coef_beta'] = 1.5
    ref = _jax_generate(jlm, params, condition_tensors=jcond,
                        prompt=None if prompt is None else jnp.asarray(prompt), **kw)
    out = tlm.generate(condition_tensors=tcond,
                       prompt=None if prompt is None else torch.from_numpy(prompt), **kw)
    assert out.shape == ref.shape == (B, 4, 14 - (5 if with_prompt else 0))
    assert ((out >= 0) & (out < 50)).all()
    np.testing.assert_array_equal(out.numpy(), ref)


def test_kv_buckets_are_token_exact(small):
    _, _, tlm = small
    _, tcond = _both(*_conditions(4, 32, seed=10))
    kw = dict(condition_tensors=tcond, num_samples=2, max_gen_len=30, use_sampling=False)
    plan = lm_model._plan_cache_segments(1, 33, 0, [8, 16])
    assert plan == [(1, 9, 8), (9, 17, 16), (17, 33, 33)]
    full = tlm.generate(**kw)
    states = []
    bucketed = tlm.generate(kv_buckets=[8, 16], _eager=True, _state_out=states, **kw)
    assert [c[0].capacity for c in states[0].caches] == [8, 16, 34]
    np.testing.assert_array_equal(bucketed.numpy(), full.numpy())
    assert lm_model._auto_capacities(1553) == [256, 512, 1024]
    assert lm_model._auto_capacities(1000) == []


def test_int8_kv_tokens_equal_jax(small):
    jlm, params, tlm = small
    jcond, tcond = _both(*_conditions(4, 32, seed=11))
    kw = dict(num_samples=2, max_gen_len=16, use_sampling=False, kv_dtype='int8')
    ref = _jax_generate(jlm, params, condition_tensors=jcond, **kw)
    out = tlm.generate(condition_tensors=tcond, **kw)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("mode", ['int8', 'int4'])
def test_quantized_weights_equal_jax_arrays_and_tokens(mode):
    jlm, params, tlm = _pair(seed=12, norm_first=True, **SMALL)
    qparams = _np_tree(jax_quantize_lm_params(jax.tree.map(jnp.asarray, params), mode=mode,
                                              group_size=16))
    quantize_lm_params(tlm, mode=mode, group_size=16)
    keys = ('q', 's') if mode == 'int8' else ('q4p', 's')
    layer, jlayer = tlm.transformer.layers[1], qparams['transformer']['layer1']
    pairs = [(layer.self_attn.in_proj_weight, jlayer['self_attn']['in_proj_weight']),
             (layer.cross_attention.out_proj.weight, jlayer['cross_attention']['out_proj']
              ['weight']),
             (layer.linear2.weight, jlayer['linear2']['weight'])]
    for ours, theirs in pairs:
        assert isinstance(ours, QuantizedWeight) and ours.mode == mode
        for key in keys:
            np.testing.assert_array_equal(getattr(ours, key).numpy(), theirs[key])
        np.testing.assert_array_equal(
            dequantize_weight(ours).numpy(),
            np.asarray(jax_dequantize_weight(jax.tree.map(jnp.asarray, theirs))))
    for key in keys:
        stacked = np.stack([getattr(lin.weight, key).numpy() for lin in tlm.linears])
        np.testing.assert_array_equal(stacked, qparams['linears']['weight'][key])
    assert tlm.emb[0].weight.dtype == torch.float32 and isinstance(
        tlm.transformer.layers[0].norm1.weight, torch.nn.Parameter)
    jcond, tcond = _both(*_conditions(4, 32, seed=13))
    kw = dict(num_samples=2, max_gen_len=14, use_sampling=False)
    ref = _jax_generate(jlm, qparams, condition_tensors=jcond, **kw)
    out = tlm.generate(condition_tensors=tcond, **kw)
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError):
        quantize_lm_params(tlm, mode=mode)



def test_decode_cache_keeps_the_most_recent_states(small):
    """A DecodeCache holds four states: a hit moves a state to the end, a
    fifth signature drops the least recently used."""
    _, _, tlm = small
    _, tcond = _both(*_conditions(4, 32, seed=18))
    cache, states = DecodeCache(), []
    for n in (6, 7, 8, 9, 6, 10):
        tlm.generate(condition_tensors=tcond, num_samples=2, max_gen_len=n, use_sampling=False,
                     graph_cache=cache, _state_out=states)
    assert DecodeCache.max_states == 4 and len(cache) == 4 and states[4] is states[0]
    assert list(cache.states.values()) == [states[2], states[3], states[0], states[5]]
    cache.clear()
    assert len(cache) == 0


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_kept_states_and_cast_copy_read_new_weights(small, compute_dtype):
    """Weights loaded in place after a generate are read by the next one on
    the same DecodeCache: the state is reused, and the cast copy of
    ``compute_dtype`` is refreshed in place; a replaced weight tensor gets a
    new state (fp32) or is copied into the kept copy (bf16); quantized
    weights get a new cast copy, and int4 weights changed in place are
    unpacked again.  Each run equals a fresh model's (cast with ``.to``)."""
    tlm = copy.deepcopy(small[2])
    _, tcond = _both(*_conditions(4, 32, seed=19))
    kw = dict(condition_tensors=tcond, num_samples=2, max_gen_len=12, use_sampling=False)
    cache, states = DecodeCache(), []

    def run():
        return tlm.generate(compute_dtype=compute_dtype, graph_cache=cache, _state_out=states,
                            **kw)

    def reference():
        model = copy.deepcopy(tlm)
        return (model if compute_dtype is None else model.to(compute_dtype)).generate(**kw)

    before = run()
    np.testing.assert_array_equal(before.numpy(), reference().numpy())
    assert (states[0].lm is tlm) == (compute_dtype is None)
    gen = torch.Generator().manual_seed(22)
    tlm.load_state_dict({k: v + 0.5 * torch.randn(v.shape, generator=gen)
                         for k, v in tlm.state_dict().items()})
    after = run()
    assert states[1] is states[0] and len(cache) == 1 and not torch.equal(before, after)
    np.testing.assert_array_equal(after.numpy(), reference().numpy())

    lin = tlm.linears[0]
    lin.weight = torch.nn.Parameter(-lin.weight.detach())
    replaced = run()
    assert (states[2] is states[0]) == (compute_dtype is not None)
    assert len(cache) == (1 if compute_dtype is not None else 2)
    np.testing.assert_array_equal(replaced.numpy(), reference().numpy())

    quantize_lm_params(tlm, mode='int4', group_size=16)
    quantized = run()
    assert states[3] is not states[0]
    assert (states[3].lm is states[0].lm) == (compute_dtype is None)   # a new cast copy
    np.testing.assert_array_equal(quantized.numpy(), reference().numpy())
    for module in tlm.modules():
        if isinstance(module, QuantizedWeight):
            module.q4p.copy_(pack_int4(-unpack_int4(module.q4p)))
    flipped = run()
    assert states[4] is states[3] and not torch.equal(flipped, quantized)
    np.testing.assert_array_equal(flipped.numpy(), reference().numpy())

def test_greedy_generate_at_musicgen_small_widths():
    """MusicGen-small's widths and flags (dim 1024, 16 heads, card 2048,
    pre-norm, no biases), depth cut to 2 layers, a dozen greedy steps."""
    cfg = dict(n_q=4, card=2048, dim=1024, num_heads=16, num_layers=2, hidden_scale=4,
               norm_first=True, bias_proj=False, bias_ff=False, bias_attn=False,
               cross_attention=True, causal=True, weight_init='gaussian')
    jlm, params, tlm = _pair(seed=14, **cfg)
    jcond, tcond = _both(*_conditions(2, 1024, seed=15, t=6))
    kw = dict(num_samples=1, max_gen_len=9, use_sampling=False)
    ref = _jax_generate(jlm, params, condition_tensors=jcond, **kw)
    out = tlm.generate(condition_tensors=tcond, **kw)
    np.testing.assert_array_equal(out.numpy(), ref)


# -------------------------------------------------------------- sampling
def test_uniforms_drawn_up_front_are_the_per_step_draws():
    probs = torch.softmax(torch.from_numpy(np.random.RandomState(16).randn(6, 2, 4, 50)
                                           .astype(np.float32)), -1)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    per_step = [sampling.sample_token(p.log(), True, 1.0, 10, 0.0, g1) for p in probs]
    u = sampling.draw_uniforms(g2, 6, (2, 4))
    assert u.shape == (6, 2, 4, 1)
    up_front = [sampling.sample_token(p.log(), True, 1.0, 10, 0.0, u=u[i])
                for i, p in enumerate(probs)]
    for a, b in zip(per_step, up_front):
        assert torch.equal(a, b)


@pytest.mark.parametrize("top_k,top_p", [(10, 0.0), (0, 0.8)])
def test_sampled_generate_equals_a_per_step_reference_loop(small, top_k, top_p):
    """Sampled tokens of generate (caches, uniforms drawn up front) against
    a cache-free loop that runs the whole prefix each step and draws per
    step from a generator seeded alike; a reused decode state repeats them."""
    _, _, tlm = small
    B, max_gen_len, cfg_coef = 2, 12, 3.0
    _, tcond = _both(*_conditions(2 * B, 32, seed=17))
    kw = dict(use_sampling=True, temp=1.0, top_k=top_k, top_p=top_p, cfg_coef=cfg_coef)
    cache = DecodeCache()
    out = tlm.generate(torch.Generator().manual_seed(5), condition_tensors=tcond,
                       num_samples=B, max_gen_len=max_gen_len, graph_cache=cache, **kw)
    again = tlm.generate(torch.Generator().manual_seed(5), condition_tensors=tcond,
                         num_samples=B, max_gen_len=max_gen_len, graph_cache=cache, **kw)
    assert len(cache) == 1 and torch.equal(out, again)

    pattern = tlm.pattern_provider.get_pattern(max_gen_len)
    seq, _, mask = pattern.build_pattern_sequence(
        torch.full((B, 4, max_gen_len), -1, dtype=torch.long), tlm.special_token_id)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for offset in range(1, seq.shape[-1]):
            logits = tlm(torch.cat([seq[..., :offset]] * 2), tcond)[:, :, -1]
            logits = logits[B:] + (logits[:B] - logits[B:]) * cfg_coef
            token = sampling.sample_token(logits, True, 1.0, top_k, top_p, gen)
            token = torch.where(torch.as_tensor(mask[:, offset])[None], token,
                                tlm.special_token_id)
            seq[..., offset] = torch.where(seq[..., offset] == -1, token, seq[..., offset])
    ref = pattern.revert_pattern_sequence(seq, special_token=-1)[0]
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
