"""The port's joint-embedding (CLAP) conditioner against the JAX package, on
the CPU: with and without the RVQ bottleneck, the empty rows' mask, the
``text_p`` swap, the windowed average, and ``make_clap_embed_fns`` over a
tiny randomly initialised ``transformers`` ``ClapModel`` (nothing is
downloaded).

The JAX conditioner's params come from its ``init`` under ``jax.jit`` and
reach the port through ``ckpt/from_jax.conditioners_state_from_jax``.
Tolerances: the condition within 1e-5 of its largest value (fp32), the
bottleneck's codes equal, CLAP embeddings within 1e-5 (both sides run the
same torch model; the resampling differs in summation order only).
"""

import numpy as np
import pytest
import torch

import jax

from audiocraft_tpu.cond.attributes import JointEmbedCondition as JaxJoint
from audiocraft_tpu.cond.joint_embed import JointEmbeddingConditioner as JaxConditioner
from audiocraft_tpu.cond.joint_embed import windowed_average_embedding as jax_windowed
from audiocraft_tpu_torch.ckpt.from_jax import conditioners_state_from_jax
from audiocraft_tpu_torch.cond.attributes import JointEmbedCondition
from audiocraft_tpu_torch.cond.conditioners import ConditioningProvider
from audiocraft_tpu_torch.cond.joint_embed import (JointEmbeddingConditioner,
                                                   windowed_average_embedding)

DIM, OUT = 16, 24


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread, as the other port test files run it: the CPU's
    convolutions at these sizes are slower on several threads, and the
    whole run's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _embed(x):
    """A seeded stand-in for CLAP: a row of the wav's statistics and noise."""
    B = x.wav.shape[0]
    rng = np.random.RandomState(int(x.wav.shape[-1]))
    embeds = rng.randn(B, DIM).astype(np.float32) + x.wav.reshape(B, -1).mean(1)[:, None]
    return embeds, [i for i in range(B) if x.length[i] <= 1]


def _text_embed(x):
    return np.full((x.wav.shape[0], DIM), 0.5, np.float32), []


def _condition(B=3, T=1000, empty=()):
    wav = np.random.RandomState(0).randn(B, 1, T).astype(np.float32)
    length = np.array([1 if i in empty else T for i in range(B)])
    return JointEmbedCondition(wav, ['a'] * B, length, [48000] * B, [None] * B, [None] * B)


def _pair(quantize: bool, seed: int = 0):
    kw = dict(dim=DIM, output_dim=OUT, quantize=quantize, n_q=4, bins=32)
    jcond = JaxConditioner(embed_fn=_embed, **kw)
    params = jax.tree.map(np.asarray, jax.jit(jcond.init)(jax.random.PRNGKey(seed)))
    tcond = JointEmbeddingConditioner(embed_fn=_embed, text_embed_fn=_text_embed, **kw)
    ConditioningProvider({'clap': tcond}).load_state_dict(
        conditioners_state_from_jax(ConditioningProvider({'clap': tcond}), {'clap': params}),
        strict=True)
    return jcond, params, tcond


@pytest.mark.parametrize('quantize', [True, False], ids=['rvq', 'no-rvq'])
def test_conditioner_matches_jax(quantize):
    """The condition [B, 1, OUT] and its mask, an empty row among them."""
    jcond, params, tcond = _pair(quantize)
    x = _condition(empty=(1,))
    out, mask = tcond(tcond.tokenize(x))
    ref, ref_mask = jcond(params, jcond.tokenize(JaxJoint(*x)))
    assert out.shape == (3, 1, OUT) and mask.shape == (3, 1)
    assert _rel(out, ref) < 1e-5
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert (out[1] == 0).all() and mask[1, 0] == 0


def test_bottleneck_codes_match_jax():
    """The RVQ eval forward (K1's plain version on the CPU) gives JAX's codes
    and their vectors' sum."""
    jcond, params, tcond = _pair(True, seed=3)
    embeds = np.random.RandomState(2).randn(8, DIM).astype(np.float32)
    res = tcond.rvq(torch.from_numpy(embeds)[:, :, None], frame_rate=1.0)
    ref, _ = jcond.quantizer.forward(jax.tree.map(jax.numpy.asarray, _rvq_state(params)),
                                     embeds[:, :, None], frame_rate=1.0, training=False)
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(ref.codes))
    assert _rel(res.x, ref.x) < 1e-6
    assert tcond.rvq.n_q == 4 and tcond.rvq.bins == 32 and not tcond.rvq.kmeans_init


def _rvq_state(params):
    from audiocraft_tpu.quant.vq import RVQState
    state = params['rvq']
    return state if isinstance(state, RVQState) else RVQState(**state)


def test_all_empty_rows_are_masked_to_zero():
    _, _, tcond = _pair(False, seed=1)
    out, mask = tcond(tcond.tokenize(_condition(B=2, empty=(0, 1))))
    assert (mask == 0).all() and (out == 0).all()


def test_text_p_swaps_in_the_text_embedding():
    _, _, tcond = _pair(False)
    tcond.text_p = 1.0
    gen = torch.Generator().manual_seed(0)
    embeds, _ = tcond.tokenize(_condition(), generator=gen, training=True)
    assert (embeds == 0.5).all()
    embeds, _ = tcond.tokenize(_condition(), training=False)
    assert not (embeds == 0.5).all()
    tcond.text_p = 0.0
    embeds, _ = tcond.tokenize(_condition(), generator=gen, training=True)
    assert not (embeds == 0.5).all()
    with pytest.raises(ValueError):
        JointEmbeddingConditioner(DIM, OUT).tokenize(_condition())


@pytest.mark.parametrize('length,max_frames,stride', [(80, 100, 50), (200, 100, 50),
                                                      (230, 100, 40), (101, 100, 100)])
def test_windowed_average_matches_jax(length, max_frames, stride):
    wav = np.random.RandomState(length).randn(2, length).astype(np.float32)
    calls = []

    def clip(w):
        calls.append(w.shape[-1])
        return np.stack([w.mean(-1), w.std(-1)], axis=-1)

    ours = windowed_average_embedding(clip, wav, max_frames, stride)
    n = len(calls)
    ref = jax_windowed(clip, wav, max_frames, stride)
    assert calls[:n] == calls[n:]
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


@pytest.fixture(scope='module')
def clap():
    transformers = pytest.importorskip('transformers')
    torch.manual_seed(0)
    cfg = transformers.ClapConfig(
        text_config=dict(num_hidden_layers=1, vocab_size=1000, hidden_size=64,
                         intermediate_size=128, num_attention_heads=2),
        audio_config=dict(depths=[1, 1, 1, 1], num_attention_heads=[1, 2, 4, 8],
                          patch_embeds_hidden_size=32, hidden_size=256),
        projection_dim=64)
    return transformers.ClapModel(cfg).eval()


def test_clap_embed_fn_matches_jax_and_drives_the_conditioner(clap):
    """``make_clap_embed_fns`` over the same ClapModel on each side: the
    normalised audio embeddings (a row resampled from 32 kHz, a 20 s row
    averaged over two windows, an empty row) within 1e-5; the conditioner runs
    on them with the empty row masked."""
    from audiocraft_tpu.cond.clap import make_clap_embed_fns as jax_make
    from audiocraft_tpu_torch.cond.clap import make_clap_embed_fns

    embed_fn, _ = make_clap_embed_fns(clap, max_seconds=10.0, stride_seconds=5.0)
    ref_fn, _ = jax_make(clap, max_seconds=10.0, stride_seconds=5.0)
    rng = np.random.RandomState(0)
    wav = rng.randn(3, 1, 20 * 32000).astype(np.float32) * 0.1
    x = JointEmbedCondition(wav, [None] * 3, np.array([32000, 20 * 32000, 1]), [32000] * 3,
                            [None] * 3, [0.0] * 3)
    torch.manual_seed(1)
    ours, empty = embed_fn(x)
    torch.manual_seed(1)
    ref, ref_empty = ref_fn(JaxJoint(*x))
    assert empty == ref_empty == [2]
    assert ours.shape == (3, clap.config.projection_dim)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    cond = JointEmbeddingConditioner(clap.config.projection_dim, 16, embed_fn=embed_fn)
    out, mask = cond(cond.tokenize(x))
    assert out.shape == (3, 1, 16) and torch.isfinite(out).all()
    assert mask[:, 0].tolist() == [1.0, 1.0, 0.0]


def test_clap_text_embed_fn_needs_a_tokenizer(clap):
    from audiocraft_tpu_torch.cond.clap import make_clap_embed_fns

    _, text_fn = make_clap_embed_fns(clap)
    with pytest.raises(ValueError):
        text_fn(_condition())
