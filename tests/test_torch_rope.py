"""The port's rotary positions (``nn/rope.py``), ``positional_embedding`` and
``kv_repeat`` against the JAX package, on the CPU.

Weights are the port's seeded init in the JAX package's tree
(``test_torch_codec_train.jax_tree_from_port`` through
``ckpt/from_jax.lm_state_from_jax``, which carries the narrower
``in_proj_weight`` of ``kv_repeat > 1``); inputs are made from a seed with
numpy.  ``rotate`` compares within 1e-6 (fp32, at positions up to 40),
logits within 1e-5 (fp32, only the order of the sums differs) and greedy
tokens exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.cond.fuser import ConditionFuser as JaxFuser
from audiocraft_tpu.lm.model import LMModel as JaxLM
from audiocraft_tpu.nn.rope import RotaryEmbedding as JaxRope
from audiocraft_tpu.patterns import DelayedPatternProvider as JaxDelayed
from audiocraft_tpu_torch.ckpt.from_jax import lm_state_from_jax
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.nn.rope import RotaryEmbedding
from audiocraft_tpu_torch.nn.transformer import StreamingMultiheadAttention, StreamingTransformer
from audiocraft_tpu_torch.patterns import DelayedPatternProvider

from test_torch_codec_train import jax_tree_from_port

FUSE = {'cross': ('description',)}
SMALL = dict(n_q=4, card=50, dim=32, num_heads=4, num_layers=2, cross_attention=True,
             causal=True, norm_first=True)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, **cfg):
    """A JAX LM with its params and a port LM holding the same weights: the
    port's seeded init in JAX's tree (no JAX init compile)."""
    jlm = JaxLM(pattern_provider=JaxDelayed(cfg['n_q']), fuser=JaxFuser.from_dict(FUSE), **cfg)
    tlm = LMModel(ConditionFuser.from_dict(FUSE), pattern_provider=DelayedPatternProvider(
        cfg['n_q']), generator=torch.Generator().manual_seed(seed), **cfg).eval()
    params = jax_tree_from_port(jlm.init, tlm.state_dict(),
                                functools.partial(lm_state_from_jax, tlm))
    return jlm, params, tlm


def _conditions(rows, dim, seed, t=5):
    cond = np.random.RandomState(seed).randn(rows, t, dim).astype(np.float32)
    mask = np.ones((rows, t), np.int32)
    mask[-1, t // 2:] = 0
    cond = (cond * mask[..., None]).astype(np.float32)
    return ({'description': (jnp.asarray(cond), jnp.asarray(mask))},
            {'description': (torch.from_numpy(cond), torch.from_numpy(mask))})


@pytest.mark.parametrize("xpos,scale,invert", [(False, 1.0, False), (True, 1.0, False),
                                               (True, 0.5, True), (False, 0.7, True)])
def test_rotate_matches_jax(xpos, scale, invert):
    x = np.random.RandomState(0).randn(2, 40, 3, 16).astype(np.float32)
    pos = np.arange(40) + 3
    ref = JaxRope(16, xpos=xpos, scale=scale).rotate(jnp.asarray(x), jnp.asarray(pos),
                                                      invert_decay=invert)
    out = RotaryEmbedding(16, xpos=xpos, scale=scale).rotate(
        torch.from_numpy(x), torch.from_numpy(pos), invert_decay=invert)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_rotate_keeps_bf16_and_computes_in_fp32():
    x = torch.randn(1, 5, 2, 8, generator=torch.Generator().manual_seed(1))
    rope = RotaryEmbedding(8, xpos=True)
    out = rope.rotate(x.bfloat16(), torch.arange(5))
    assert out.dtype == torch.bfloat16
    ref = rope.rotate(x.bfloat16().float(), torch.arange(5))
    torch.testing.assert_close(out.float(), ref.bfloat16().float(), rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [dict(positional_embedding='rope'),
                                 dict(positional_embedding='sin_rope'),
                                 dict(kv_repeat=2),
                                 dict(positional_embedding='rope', kv_repeat=2),
                                 dict(positional_embedding='sin_rope', kv_repeat=4,
                                      norm_first=False)])
def test_lm_forward_matches_jax(cfg):
    jlm, params, tlm = _pair(seed=1, **dict(SMALL, **cfg))
    kv = cfg.get('kv_repeat', 1)
    assert tlm.transformer.layers[0].self_attn.in_proj_weight.shape == (32 + 2 * 32 // kv, 32)
    seq = np.random.RandomState(2).randint(0, 51, (2, 4, 9))
    jcond, tcond = _conditions(2, 32, seed=3)
    ref, _ = jlm.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(seq), jcond)
    with torch.no_grad():
        out = tlm(torch.from_numpy(seq), tcond)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cfg,kv_dtype", [(dict(positional_embedding='rope'), None),
                                          (dict(positional_embedding='sin_rope', kv_repeat=2),
                                           None),
                                          (dict(positional_embedding='rope', kv_repeat=2),
                                           'int8')])
def test_cached_decode_with_rope_equals_the_batch_forward(cfg, kv_dtype):
    """Rope positions continue at the cache index: a prefill of 4 steps then
    one step at a time gives the cache-free forward's logits (fp32 cache;
    the int8 cache within its quantisation error)."""
    _, _, tlm = _pair(seed=4, **dict(SMALL, **cfg))
    seq = torch.from_numpy(np.random.RandomState(5).randint(0, 51, (2, 4, 11)))
    tcond = _conditions(2, 32, seed=6)[1]
    with torch.no_grad():
        full = tlm(seq, tcond)
        caches = tlm.init_cache(2, 16, kv_dtype=kv_dtype)
        assert caches[0].k.shape[2] == 4 // cfg.get('kv_repeat', 1)
        cross_kv = tlm.transformer.precompute_cross_kv(tlm.cross_source(tcond, 2))
        steps = [tlm(seq[..., :4], tcond, cross_kv=cross_kv, caches=caches)]
        for t in range(4, 11):
            steps.append(tlm(seq[..., t:t + 1], tcond, cross_kv=cross_kv, caches=caches))
    tol = 1e-5 if kv_dtype is None else 5e-2
    np.testing.assert_allclose(torch.cat(steps, dim=2).numpy(), full.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("cfg,kv_dtype", [(dict(positional_embedding='rope', kv_repeat=2), None),
                                          (dict(positional_embedding='rope', kv_repeat=2),
                                           'int8'),
                                          (dict(positional_embedding='sin_rope'), None)])
def test_greedy_tokens_equal_jax(cfg, kv_dtype):
    jlm, params, tlm = _pair(seed=7, **dict(SMALL, **cfg))
    jcond, tcond = _conditions(4, 32, seed=8)
    kw = dict(num_samples=2, max_gen_len=16, use_sampling=False, kv_dtype=kv_dtype)
    ref = np.asarray(jlm.generate(jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(0),
                                  condition_tensors=jcond, **kw))
    out = tlm.generate(condition_tensors=tcond, **kw)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_kv_repeat_route_through_the_kernel_wrapper_equals_plain():
    """The flash route (its plain version on the CPU) takes k and v repeated
    to the q heads: the same output as the masked plain route."""
    mha = StreamingMultiheadAttention(32, 4, causal=True, kv_repeat=2, attn_kernel=True,
                                      rope=RotaryEmbedding(8))
    plain = StreamingMultiheadAttention(32, 4, causal=True, kv_repeat=2, attn_kernel=False,
                                        rope=RotaryEmbedding(8))
    plain.load_state_dict(mha.state_dict())
    x = torch.randn(2, 7, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        torch.testing.assert_close(mha(x), plain(x), rtol=1e-6, atol=1e-6)


def test_refusals():
    with pytest.raises(ValueError, match='kv_repeat'):
        StreamingMultiheadAttention(32, 4, qk_layer_norm=True, kv_repeat=2)
    with pytest.raises(ValueError, match='rope'):
        StreamingMultiheadAttention(32, 4, cross_attention=True, rope=RotaryEmbedding(8))
    with pytest.raises(ValueError, match='positional_embedding'):
        StreamingTransformer(32, 4, 1, positional_embedding='alibi')
    with pytest.raises(ValueError, match='share'):
        StreamingMultiheadAttention(32, 4, kv_repeat=3)
