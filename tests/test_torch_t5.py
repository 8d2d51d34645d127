"""The port's T5 encoder and T5 conditioner against recorded HF goldens and
the JAX package's T5, on the CPU.

The goldens (tests/goldens/t5_golden_{relu,gated}.npz) hold a tiny random
HF T5 encoder's state dict, its inputs and its hidden states; the port loads
the state dict under the same names.  Tolerances: 2e-4 absolute and 1e-3
relative on valid positions against the goldens, the JAX suite's bar
(tests/test_hf_goldens.py); 1e-5 against the JAX T5 on shared weights, both
sides in fp32.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.cond.conditioners import T5Conditioner as JaxT5Conditioner
from audiocraft_tpu.nn.t5 import T5Encoder as JaxT5Encoder
from audiocraft_tpu.nn.t5 import T5EncoderConfig as JaxT5Config
from audiocraft_tpu_torch.ckpt.from_jax import conditioners_state_from_jax, t5_state_from_jax
from audiocraft_tpu_torch.cond.conditioners import ConditioningProvider, T5Conditioner
from audiocraft_tpu_torch.nn.t5 import T5Encoder, T5EncoderConfig, relative_position_bucket

GOLDENS = Path(__file__).parent / "goldens"
SMALL = dict(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=3, num_heads=4)


@pytest.mark.parametrize("variant", ["relu", "gated"])
def test_t5_matches_hf_golden(variant):
    data = np.load(GOLDENS / f"t5_golden_{variant}.npz")
    # HF ties encoder.embed_tokens to shared; the port keeps only shared
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd.") and k != "sd.encoder.embed_tokens.weight"}
    model = T5Encoder(T5EncoderConfig(**SMALL, gated_act=variant == "gated")).eval()
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(data["ids"]), torch.from_numpy(data["mask"])).numpy()
    valid = data["mask"].astype(bool)
    np.testing.assert_allclose(out[valid], data["hidden"][valid], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("gated", [False, True])
def test_t5_matches_jax_on_shared_weights(gated):
    jcfg = JaxT5Config(**SMALL, gated_act=gated)
    params = jax.tree.map(np.asarray, JaxT5Encoder(jcfg).init(jax.random.PRNGKey(int(gated))))
    model = T5Encoder(T5EncoderConfig(**SMALL, gated_act=gated)).eval()
    model.load_state_dict(t5_state_from_jax(params), strict=True)
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 512, (3, 11)).astype(np.int32)
    mask = np.ones((3, 11), np.int32)
    mask[1, 7:] = 0
    mask[2, :] = 0          # a null condition: every position masked
    ref = np.asarray(JaxT5Encoder(jcfg)(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                                        jnp.asarray(mask)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_relative_position_buckets_cover_long_distances():
    pos = np.arange(300)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None])
    assert buckets.min() == 0 and buckets.max() == 31
    assert (np.diag(buckets) == 0).all()


def test_t5_conditioner_matches_jax():
    jcond = JaxT5Conditioner(name='t5-base', output_dim=24, config=JaxT5Config(**SMALL))
    params = jax.tree.map(np.asarray, jcond.init(jax.random.PRNGKey(5)))
    provider = ConditioningProvider.from_dict({
        'description': T5Conditioner(name='t5-base', output_dim=24,
                                     config=T5EncoderConfig(**SMALL))}).eval()
    provider.load_state_dict(conditioners_state_from_jax(provider, {'description': params}),
                             strict=True)
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 512, (4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.int32)
    mask[2:] = 0             # the null rows of CFG
    ref_emb, ref_mask = jcond(jax.tree.map(jnp.asarray, params),
                              (jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        emb, out_mask = provider({'description': (torch.from_numpy(ids),
                                                  torch.from_numpy(mask))})['description']
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref_emb), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    assert not emb[2:].any()


class _FakeTokenizer:
    """An HF-style tokenizer: one id per character, padded with 0."""

    def __call__(self, texts, return_tensors, padding):
        assert return_tensors == 'np' and padding
        T = max(1, max(len(t) for t in texts))
        ids = np.zeros((len(texts), T), np.int64)
        mask = np.zeros((len(texts), T), np.int64)
        for i, t in enumerate(texts):
            ids[i, :len(t)] = [ord(c) % 500 + 1 for c in t]
            mask[i, :len(t)] = 1
        return {'input_ids': ids, 'attention_mask': mask}


def test_t5_tokenize_takes_an_explicit_tokenizer_and_never_guesses_one():
    cond = T5Conditioner(name='t5-base', output_dim=8, config=T5EncoderConfig(**SMALL))
    ids, mask = cond.tokenize(['ab', None, 'abcd'], tokenizer=_FakeTokenizer())
    assert ids.shape == (3, 4) and mask[1].sum() == 0 and mask[2].sum() == 4
    with pytest.raises(RuntimeError, match="vocabulary"):
        cond.tokenize(['ab'])
