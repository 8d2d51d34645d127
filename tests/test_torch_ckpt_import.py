"""The port's reference-checkpoint importer (``ckpt/torch_import.py``) and
``quant/base.py`` against the recorded goldens and the JAX package, on the
CPU.

The goldens hold reference state dicts and what the reference computed with
them: ``debug_codec_state.npz`` with ``asset_tokens.npz`` (codes, compared
bit for bit), ``debug_lm_state.npz`` with ``debug_lm_greedy.npz`` (greedy
tokens, exactly) and ``t5_golden_{relu,gated}.npz`` (hidden states within
2e-4 absolute and 1e-3 relative, the JAX suite's bar).  The weight-norm fold
is held bit for bit against JAX's ``get_conv_weight``, and the unread keys
against JAX's ``KeyTracker``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocraft_tpu.builders import get_debug_compression_model as jax_debug_codec
from audiocraft_tpu.builders import get_debug_musicgen_lm as jax_debug_lm
from audiocraft_tpu.ckpt import torch_import as jax_import
from audiocraft_tpu.quant.base import DummyQuantizer as JaxDummy
from audiocraft_tpu_torch.builders import get_debug_compression_model, get_debug_musicgen_lm
from audiocraft_tpu_torch.ckpt import torch_import
from audiocraft_tpu_torch.ckpt.from_jax import encodec_state_from_jax
from audiocraft_tpu_torch.cond.fuser import ConditionFuser
from audiocraft_tpu_torch.lm.model import LMModel
from audiocraft_tpu_torch.nn.t5 import T5Encoder, T5EncoderConfig
from audiocraft_tpu_torch.patterns import DelayedPatternProvider
from audiocraft_tpu_torch.quant.base import DummyQuantizer, QuantizedResult

GOLDENS = Path(__file__).parent / "goldens"


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    with np.load(GOLDENS / name) as data:
        return {k: data[k] for k in data.files}


def test_codec_state_golden_gives_the_reference_tokens():
    sd = torch_import.KeyTracker(_load("debug_codec_state.npz"))
    codec = get_debug_compression_model(32000, device='cpu')
    codec.load_state_dict(torch_import.to_tensors(torch_import.import_encodec(codec, sd)))
    assert sd.unused() == []
    assets = _load("asset_tokens.npz")
    names = [k for k in assets if not k.endswith("__pcm")]
    assert len(names) == 4
    for name in names:
        codes, _ = codec.encode(torch.from_numpy(assets[name + "__pcm"]))
        np.testing.assert_array_equal(codes.numpy(), assets[name], err_msg=name)


def test_lm_state_golden_gives_the_greedy_tokens():
    lm = LMModel(ConditionFuser.from_dict({'cross': ('description',)}), n_q=4, card=60,
                 dim=16, num_heads=4, num_layers=2, cross_attention=True, causal=True,
                 norm_first=False, activation='relu',
                 pattern_provider=DelayedPatternProvider(4)).eval()
    sd = torch_import.KeyTracker(_load("debug_lm_state.npz"))
    lm.load_state_dict(torch_import.to_tensors(torch_import.import_lm(lm, sd)))
    assert sd.unused() == []
    g = _load("debug_lm_greedy.npz")
    tokens = lm.generate(condition_tensors={'description': (torch.from_numpy(g['cond']),
                                                            torch.from_numpy(g['mask']))},
                         num_samples=2, max_gen_len=10, use_sampling=False, cfg_coef=3.0)
    np.testing.assert_array_equal(tokens.numpy(), g['tokens'])


@pytest.mark.parametrize("variant", ["relu", "gated"])
def test_t5_goldens_through_import_t5(variant):
    data = _load(f"t5_golden_{variant}.npz")
    sd = torch_import.KeyTracker({k[3:]: v for k, v in data.items() if k.startswith("sd.")})
    cfg = T5EncoderConfig(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=3,
                          num_heads=4, gated_act=variant == "gated")
    model = T5Encoder(cfg).eval()
    model.load_state_dict(torch_import.to_tensors(
        torch_import.import_t5(sd, cfg.num_layers, gated=cfg.gated_act)))
    # HF ties encoder.embed_tokens to shared
    assert sd.unused() == ['encoder.embed_tokens.weight']
    with torch.no_grad():
        out = model(torch.from_numpy(data["ids"]), torch.from_numpy(data["mask"])).numpy()
    valid = data["mask"].astype(bool)
    np.testing.assert_allclose(out[valid], data["hidden"][valid], atol=2e-4, rtol=1e-3)


def _factored(sd, layout, seed):
    """``sd`` with every conv weight split into weight-norm factors: g the
    weight's norm over all axes but the first, v the weight scaled by a
    random positive factor per row (so the fold has real work)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, w in sd.items():
        if not key.endswith(('conv.conv.weight', 'convtr.convtr.weight')):
            out[key] = w
            continue
        base = key[:-len('.weight')]
        v = w * rng.uniform(0.5, 2.0, (w.shape[0],) + (1,) * (w.ndim - 1)).astype(np.float32)
        g = np.sqrt(np.sum(np.square(w), axis=tuple(range(1, w.ndim)), keepdims=True))
        names = (('weight_g', 'weight_v') if layout == 'weight_g'
                 else ('parametrizations.weight.original0', 'parametrizations.weight.original1'))
        out[f'{base}.{names[0]}'], out[f'{base}.{names[1]}'] = g, v
    return out


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_weight_norm_fold_equals_jax_bit_for_bit(layout):
    """A reference codec state with factored conv weights: the port's folded
    state equals the JAX importer's tree, leaf for leaf, bit for bit; a
    factored weight alone folds to JAX's value too (a torch tensor input
    included)."""
    sd = _factored(_load("debug_codec_state.npz"), layout, seed=1)
    codec = get_debug_compression_model(32000, device='cpu')
    ours = torch_import.import_encodec(codec, torch_import.KeyTracker(sd))
    theirs = encodec_state_from_jax(codec, jax_import.import_encodec(jax_debug_codec(32000), sd))
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key].numpy(), err_msg=key)
    prefix = 'encoder.model.3.conv.conv'
    tensors = {k: torch.from_numpy(v) for k, v in sd.items() if k.startswith(prefix)}
    np.testing.assert_array_equal(torch_import.get_conv_weight(tensors, prefix),
                                  jax_import.get_conv_weight(sd, prefix))


def test_key_tracker_unused_equals_jax():
    sd = _load("debug_codec_state.npz")
    sd.update({'encoder.model.99.conv.conv.weight': np.zeros(3, np.float32),
               'quantizer.vq.layers.0._codebook.num_batches_tracked': np.zeros((), np.int64),
               'extra.buffer': np.ones(2, np.float32)})
    ours, theirs = torch_import.KeyTracker(sd), jax_import.KeyTracker(sd)
    torch_import.import_encodec(get_debug_compression_model(32000, device='cpu'), ours)
    jax_import.import_encodec(jax_debug_codec(32000), theirs)
    assert ours.unused() == theirs.unused() == sorted(
        ['encoder.model.99.conv.conv.weight', 'extra.buffer',
         'quantizer.vq.layers.0._codebook.num_batches_tracked'])
    ignore = torch_import.HARMLESS_BUFFER_PATTERNS
    assert ours.unused(ignore) == theirs.unused(jax_import.HARMLESS_BUFFER_PATTERNS) == [
        'encoder.model.99.conv.conv.weight', 'extra.buffer']


def test_conditioner_import_and_merge():
    """A reference LM export carries the conditioners' trained weights under
    ``condition_provider.``: the port's import selects them, as the JAX
    importer does, and ``merge_params`` leaves the rest seeded and names
    it."""
    _, provider = get_debug_musicgen_lm(device='cpu', seed=3)
    _, target = get_debug_musicgen_lm(device='cpu', seed=4)
    ref = {f'condition_provider.{k}': v.numpy() for k, v in provider.state_dict().items()}
    ref.pop('condition_provider.conditioners.description.output_proj.bias')
    ours = torch_import.import_conditioners(target, torch_import.KeyTracker(ref))
    theirs = jax_import.import_conditioners(jax_debug_lm()[1], ref)
    assert sorted(ours) == ['conditioners.description.embed.weight',
                            'conditioners.description.output_proj.weight']
    np.testing.assert_array_equal(ours['conditioners.description.embed.weight'],
                                  theirs['description']['embed'])
    np.testing.assert_array_equal(ours['conditioners.description.output_proj.weight'],
                                  theirs['description']['output_proj']['weight'])
    _, fresh = get_debug_musicgen_lm(device='cpu', seed=4)
    assert torch_import.merge_params(fresh, ours) == [
        'conditioners.description.output_proj.bias']
    assert torch.equal(fresh.conditioners['description'].embed.weight,
                       provider.conditioners['description'].embed.weight)
    with pytest.raises(KeyError, match='does not have'):
        torch_import.merge_params(fresh, {'conditioners.nothing.weight': np.zeros(1)})


def test_dummy_quantizer_matches_jax():
    x = np.random.RandomState(2).randn(3, 8, 11).astype(np.float32)
    ours, theirs = DummyQuantizer(dimension=8), JaxDummy(dimension=8)
    res = ours(torch.from_numpy(x), frame_rate=25.0)
    jres, _ = theirs.forward({}, jnp.asarray(x), frame_rate=25.0)
    assert isinstance(res, QuantizedResult)
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(jres.codes))
    np.testing.assert_array_equal(res.x.numpy(), np.asarray(jres.x))
    assert float(res.bandwidth) == float(jres.bandwidth) and float(res.penalty) == 0.0
    codes = ours.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(theirs.encode({}, jnp.asarray(x))))
    np.testing.assert_array_equal(ours.decode(codes).numpy(), x)
    assert (ours.num_codebooks, ours.total_codebooks, ours.max_n_q) == (1, 1, 1)
    with pytest.raises(AttributeError):
        ours.set_num_codebooks(2)
