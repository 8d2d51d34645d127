"""The port's codec wrappers (``codec/wrappers.py``) against the JAX
package's, on the CPU.

The HF EnCodec wrapper reproduces the recorded golden
(``tests/goldens/hf_encodec_golden.npz``: a tiny random HF model's state dict,
a signal and the codes HF gave) with no ``transformers`` at all, and, where
``transformers`` is installed, matches the JAX wrapper's encode tokens
(exactly) and decode waveform (1e-5, fp32) on a live HF model.  The DAC
wrapper's contract is held against JAX's over a fake backend on each side.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.codec import wrappers as jwrappers
from audiocraft_tpu_torch.codec import wrappers

GOLDENS = Path(__file__).parent / "goldens"


def test_hf_wrapper_reproduces_the_golden_codes():
    with np.load(GOLDENS / "hf_encodec_golden.npz") as data:
        g = {k: data[k] for k in data.files}
    sd = {k[3:]: v for k, v in g.items() if k.startswith("sd.")}
    ours = wrappers.HFEncodecCompressionModel.from_hf_config(json.loads(str(g["config_json"])),
                                                             device='cpu')
    state = ours.import_hf_state(sd)
    ours.model.load_state_dict(state)   # strict: every port parameter is mapped
    assert not any('norm' in k for k in state)   # a weight-norm config: folded, no GroupNorm
    codes, scale = ours.encode(torch.from_numpy(g["wav"]))
    assert scale is None and codes.shape == (2, 2, 2000)
    np.testing.assert_array_equal(codes.numpy(), g["codes"].reshape(codes.shape))


def _hf_config():
    from transformers import EncodecConfig
    # frame rate 16000 / 8 = 2000; bandwidths give 1 and 2 codebooks of 64
    return EncodecConfig(
        target_bandwidths=[12.0, 24.0], sampling_rate=16000, audio_channels=1, num_filters=4,
        upsampling_ratios=[4, 2], codebook_size=64, codebook_dim=16, hidden_size=16,
        num_lstm_layers=1, num_residual_layers=1, normalize=False, use_causal_conv=True)


@pytest.fixture(scope="module")
def hf_trio():
    """(live HF model, the JAX wrapper and its params, the port's wrapper)."""
    pytest.importorskip("transformers")
    from transformers import EncodecModel as HFEncodec

    torch.manual_seed(31)
    cfg = _hf_config()
    hf = HFEncodec(cfg).eval()
    with torch.no_grad():   # codebooks of latent frames (the init leaves them at zero)
        lat = hf.encoder(torch.randn(4, 1, 4000) * 0.3)
        frames = lat.transpose(1, 2).reshape(-1, lat.shape[1])
        for q, layer in enumerate(hf.quantizer.layers):
            pick = torch.randint(0, frames.shape[0], (layer.codebook.embed.shape[0],))
            layer.codebook.embed.copy_(frames[pick] * 0.5 ** q)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    jours = jwrappers.HFEncodecCompressionModel.from_hf_config(cfg.to_dict())
    params = jax.tree.map(jnp.asarray, jours.import_hf_state(sd))
    ours = wrappers.HFEncodecCompressionModel.from_hf_config(cfg.to_dict(), device='cpu')
    ours.model.load_state_dict(ours.import_hf_state(hf.state_dict()))   # tensors too
    return hf, jours, params, ours


def test_hf_wrapper_contract_equals_jax(hf_trio):
    _, jours, _, ours = hf_trio
    for name in ('sample_rate', 'frame_rate', 'cardinality', 'possible_num_codebooks',
                 'total_codebooks', 'num_codebooks', 'channels'):
        assert getattr(ours, name) == getattr(jours, name), name
    assert ours.possible_num_codebooks == [1, 2]
    assert jours.set_num_codebooks(1).num_codebooks == 1
    ours.set_num_codebooks(1)
    try:
        assert ours.num_codebooks == 1 and ours.total_codebooks == 2
    finally:
        ours.set_num_codebooks(2)
    with pytest.raises(ValueError):
        ours.set_num_codebooks(3)


def test_hf_wrapper_encode_tokens_equal_jax_and_hf(hf_trio):
    hf, jours, params, ours = hf_trio
    wav = np.random.RandomState(0).randn(2, 1, 16000).astype(np.float32) * 0.3
    ref, jscale = jours.encode(params, jnp.asarray(wav))
    codes, scale = ours.encode(torch.from_numpy(wav))
    assert scale is None and jscale is None and codes.shape == (2, 2, 2000)
    assert len(np.unique(codes.numpy())) > 30
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
    with torch.no_grad():
        hf_codes = hf.encode(torch.from_numpy(wav), None, bandwidth=24.0)[0][0].numpy()
    np.testing.assert_array_equal(codes.numpy(), hf_codes)


def test_hf_wrapper_decode_matches_jax_and_hf(hf_trio):
    hf, jours, params, ours = hf_trio
    codes = np.random.RandomState(1).randint(0, 64, size=(2, 2, 50))
    ref = np.asarray(jours.decode(params, jnp.asarray(codes)))
    wav = ours.decode(torch.from_numpy(codes))
    assert wav.shape == ref.shape == (2, 1, 400)
    np.testing.assert_allclose(wav.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.decode_latent(torch.from_numpy(codes)).numpy(),
                               np.asarray(jours.decode_latent(params, jnp.asarray(codes))),
                               rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        hf_wav = hf.decode(torch.from_numpy(codes)[None], [None])[0].numpy()
    n = min(wav.shape[-1], hf_wav.shape[-1])
    np.testing.assert_allclose(wav.numpy()[..., :n], hf_wav[..., :n], rtol=0, atol=2e-5)


class _FakeDAC:
    """A DAC backend on either side: ``array`` makes its outputs (jnp or torch)."""
    sample_rate, hop_length, codebook_size, n_codebooks = 44100, 512, 1024, 9

    def __init__(self, array):
        self.array = array

    def encode(self, x):
        codes = np.random.RandomState(0).randint(
            0, self.codebook_size, (x.shape[0], self.n_codebooks, x.shape[-1] // self.hop_length))
        return self.array(codes)

    def decode_latent(self, codes):
        return self.array(np.zeros((codes.shape[0], 8, codes.shape[-1]), np.float32))

    def decode(self, z_q):
        return self.array(np.zeros((z_q.shape[0], 1, z_q.shape[-1] * self.hop_length),
                                   np.float32))


def test_dac_contract_equals_jax():
    jdac = jwrappers.DACCompressionModel(backend=_FakeDAC(jnp.asarray))
    dac = wrappers.DACCompressionModel(_FakeDAC(torch.from_numpy))
    for name in ('num_codebooks', 'total_codebooks', 'cardinality', 'frame_rate',
                 'sample_rate', 'channels'):
        assert getattr(dac, name) == getattr(jdac, name), name
    x = np.zeros((2, 1, 512 * 10), np.float32)
    codes, scale = dac.encode(torch.from_numpy(x))
    jcodes, _ = jdac.encode(jnp.asarray(x))
    assert scale is None and codes.shape == (2, 9, 10)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    jdac4 = jdac.set_num_codebooks(4)
    dac.set_num_codebooks(4)
    codes4, _ = dac.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(codes4.numpy(), np.asarray(jdac4.encode(jnp.asarray(x))[0]))
    assert dac.num_codebooks == jdac4.num_codebooks == 4
    wav = dac.decode(codes4)
    assert wav.shape == np.shape(jdac4.decode(jnp.asarray(codes4.numpy()))) == (2, 1, 5120)
    with pytest.raises(ValueError):
        dac.set_num_codebooks(10)
    with pytest.raises(AssertionError):
        jdac.set_num_codebooks(10)
    assert wrappers.DACCompressionModel(_FakeDAC(torch.from_numpy), 3).num_codebooks == 3
