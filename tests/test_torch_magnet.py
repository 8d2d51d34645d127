"""The port's MAGNeT (masked parallel decoding), sampling and tokenizers
against the JAX package, on the CPU.

Weights come from the JAX package's debug MAGNeT and reach the port through
``ckpt/from_jax.py``.  Greedy decoding compares tokens exactly: both
packages take first-index argmaxes and order equal re-masking scores lower
index first.  Sampling draws differ by construction (a torch.Generator is
not a JAX key), so the filtered distributions are compared instead, at
1e-6 (both fp32, only the order of the sums differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.cond import tokenizers as jax_tokenizers
from audiocraft_tpu.cond.attributes import ClassifierFreeGuidanceDropout as JaxCFG
from audiocraft_tpu.cond.attributes import ConditioningAttributes as JaxAttrs
from audiocraft_tpu.gen.magnet import get_debug_magnet as jax_debug_magnet
from audiocraft_tpu.lm import sampling as jax_sampling
from audiocraft_tpu_torch.ckpt.from_jax import (conditioners_state_from_jax,
                                                encodec_state_from_jax, lm_state_from_jax)
from audiocraft_tpu_torch.cond import tokenizers
from audiocraft_tpu_torch.cond.attributes import (ClassifierFreeGuidanceDropout,
                                                  ConditioningAttributes)
from audiocraft_tpu_torch.gen.magnet import get_debug_magnet
from audiocraft_tpu_torch.lm import sampling
from audiocraft_tpu_torch.lm.magnet import DONT_REMASK_ME_SCORE, top_k_indices

SENTENCES = ["a short jingle", "Happy 80s synth-pop with 4 drums and 128 bpm!",
             "didn't he play the guitars loudly? 1999 vibes", "", "Jazz trio, 3 horns"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def pair():
    """The JAX debug MAGNeT and the port's, holding the same weights."""
    jmg = jax_debug_magnet(jax.random.PRNGKey(11))
    tmg = get_debug_magnet(device='cpu')
    tmg.lm.load_state_dict(lm_state_from_jax(tmg.lm, _np_tree(jmg.lm_params)), strict=True)
    tmg.condition_provider.load_state_dict(
        conditioners_state_from_jax(tmg.condition_provider, _np_tree(jmg.cond_params)),
        strict=True)
    codec = dict(_np_tree(jmg.codec_params))
    q = codec['quantizer']       # the JAX quantizer state is a dataclass
    codec['quantizer'] = dict(embed=q.embed, cluster_size=q.cluster_size,
                              embed_avg=q.embed_avg, inited=q.inited)
    tmg.compression_model.load_state_dict(
        encodec_state_from_jax(tmg.compression_model, codec))
    return jmg, tmg


def _conditions(jmg, tmg, descriptions):
    attrs = [ConditioningAttributes(text={'description': d}) for d in descriptions]
    nulls = ClassifierFreeGuidanceDropout(p=1.0)(attrs)
    tcond = tmg.condition_provider(tmg.condition_provider.tokenize(attrs + nulls))
    jattrs = [JaxAttrs(text={'description': d}) for d in descriptions]
    jcond = jmg.condition_provider(jmg.cond_params, jmg.condition_provider.tokenize(
        jattrs + JaxCFG(p=1.0)(jattrs)))
    return jcond, tcond


@pytest.mark.parametrize("arrangement,steps,with_prompt", [
    ('nonoverlap', (4, 2, 2, 2), False),
    ('stride1', (3, 2, 2, 2), False),
    ('nonoverlap', (4, 2, 2, 2), True),
])
def test_greedy_tokens_equal_jax(pair, arrangement, steps, with_prompt):
    jmg, tmg = pair
    descriptions = ['a short jingle', 'calm piano at night']
    jcond, tcond = _conditions(jmg, tmg, descriptions)
    np.testing.assert_allclose(tcond['description'][0].numpy(),
                               np.asarray(jcond['description'][0]), rtol=1e-6, atol=1e-6)
    max_gen_len = int(jmg.duration * jmg.frame_rate)
    prompt = None
    if with_prompt:
        prompt = np.random.RandomState(0).randint(0, 400, (2, 4, 7)).astype(np.int32)
    kw = dict(num_samples=2, max_gen_len=max_gen_len, use_sampling=False,
              decoding_steps=steps, span_arrangement=arrangement)
    ref = np.asarray(jmg.lm.generate_magnet(
        jmg.lm_params, jax.random.PRNGKey(0), condition_tensors=jcond,
        prompt=None if prompt is None else jnp.asarray(prompt), **kw))
    out = tmg.lm.generate_magnet(
        torch.Generator().manual_seed(0), condition_tensors=tcond,
        prompt=None if prompt is None else torch.from_numpy(prompt), **kw)
    assert out.shape == ref.shape
    assert (out.numpy() < 400).all()
    np.testing.assert_array_equal(out.numpy(), ref)
    if with_prompt:
        np.testing.assert_array_equal(out.numpy()[..., :7], prompt)


def test_facade_generates_audio_and_trims_to_whole_spans(pair):
    _, tmg = pair
    audio, tokens = tmg.generate(['a short jingle'], generator=torch.Generator().manual_seed(3),
                                 return_tokens=True)
    T = int(tmg.duration * tmg.frame_rate) // tmg.lm.span_len * tmg.lm.span_len
    assert tokens.shape == (1, 4, T) and ((tokens >= 0) & (tokens < 400)).all()
    assert audio.shape == (1, 1, T * 1280) and torch.isfinite(audio).all()


def test_restricted_context_mask_equals_jax(pair):
    jmg, tmg = pair
    ref = np.asarray(jmg.lm.restricted_context_attn_mask(16))
    np.testing.assert_array_equal(tmg.lm.restricted_context_attn_mask(16).numpy(), ref)
    assert tmg.lm.stage_attn_mask(0, 16) is None and jmg.lm.stage_attn_mask(0, 16) is None


def test_least_probable_span_masking_equals_jax(pair):
    jmg, tmg = pair
    rng = np.random.RandomState(1)
    for target in (3, 6, 12, 20):
        scores = rng.rand(30).astype(np.float32)
        scores[rng.rand(30) < 0.3] = DONT_REMASK_ME_SCORE
        ref = np.asarray(jmg.lm._least_probable_span_masking(jnp.asarray(scores), target))
        out = tmg.lm._least_probable_span_masking(torch.from_numpy(scores), target)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_remasking_order_breaks_planted_ties_like_jax_top_k():
    """Equal scores (the DONT_REMASK_ME chunks, saturated probabilities) go
    lower index first, as jax.lax.top_k orders them."""
    rng = np.random.RandomState(2)
    scores = rng.choice([0.0, 0.25, 0.5, DONT_REMASK_ME_SCORE], size=(3, 1, 40))
    scores = scores.astype(np.float32)
    for k in (1, 5, 17, 40):
        ref = np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1])
        np.testing.assert_array_equal(top_k_indices(torch.from_numpy(scores), k).numpy(), ref)


def test_tokenizer_copy_gives_the_jax_ids():
    for n_bins in (128, 50000):
        ours = tokenizers.WhiteSpaceTokenizer(n_bins)(SENTENCES + [None])
        ref = jax_tokenizers.WhiteSpaceTokenizer(n_bins)(SENTENCES + [None])
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tokenizers.NoopTokenizer(n_bins)(SENTENCES + [None]),
                        jax_tokenizers.NoopTokenizer(n_bins)(SENTENCES + [None])):
            np.testing.assert_array_equal(a, b)
    for n in (0, 7, 19, 42, 100, 999, 1234, 80000, 2_000_001):
        assert tokenizers.num2words(n) == jax_tokenizers.num2words(n)
    for word in ('guitars', 'playing', 'drove', 'hammer', 'Jazz', 'groovier', "n't"):
        assert tokenizers.lemmatize(word) == jax_tokenizers.lemmatize(word)
    assert tokenizers.hash_trick('eighty', 128) == jax_tokenizers.hash_trick('eighty', 128)


def _capture(monkeypatch, module, probs_arg):
    """Replace the module's multinomial with one that records the
    distribution it is given (argument ``probs_arg``) and draws index 0."""
    seen = []

    def fake(*args):
        probs = args[probs_arg]
        seen.append(np.asarray(probs))
        if isinstance(probs, torch.Tensor):
            return torch.zeros(probs.shape[:-1], dtype=torch.long)
        return np.zeros(probs.shape[:-1], np.int64)

    monkeypatch.setattr(module, 'multinomial', fake)
    return seen


@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (0, 0.5), (7, 0.0), (500, 0.0)])
def test_filtered_distributions_equal_jax(monkeypatch, top_k, top_p):
    logits = np.random.RandomState(top_k).randn(3, 64).astype(np.float32) * 2
    logits[0, :5] = logits[0, 5]   # planted ties
    jseen = _capture(monkeypatch, jax_sampling, 1)     # multinomial(key, probs)
    tseen = _capture(monkeypatch, sampling, 0)         # multinomial(probs, generator)
    jax_sampling.sample_token(jax.random.PRNGKey(0), jnp.asarray(logits), True, 1.5, top_k,
                              top_p)
    sampling.sample_token(torch.from_numpy(logits), True, 1.5, top_k, top_p,
                          torch.Generator())
    np.testing.assert_allclose(tseen[0], jseen[0], rtol=1e-6, atol=1e-6)


def test_multinomial_draws_follow_the_distribution():
    probs = torch.tensor([[0.0, 0.2, 0.0, 0.5, 0.3]]).expand(20000, 5)
    draws = sampling.multinomial(probs, torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=5).float() / 20000
    assert freq[0] == 0 and freq[2] == 0
    torch.testing.assert_close(freq, probs[0], atol=0.015, rtol=0)
    assert (sampling.sample_token(torch.tensor([[1.0, 3.0, 3.0]]), False, 1.0, 0, 0.0,
                                  torch.Generator()) == 1).all()
