"""The PyTorch port's codec against the JAX package, on the CPU.

Inputs are made from a seed with numpy and given to both packages; weights
come from the JAX package's init (or its golden checkpoint) and reach the
port through ``ckpt/from_jax.py``.  The port runs its kernels' plain
versions here.  Tolerances: 1e-5 where both sides compute in fp32 (only the
summation order of the two conv libraries differs); codes exactly equal, as
the JAX package held itself to the torch reference.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.builders import get_debug_compression_model as jax_debug_model
from audiocraft_tpu.builders import get_encodec_32khz as jax_encodec_32khz
from audiocraft_tpu.ckpt.torch_import import import_encodec
from audiocraft_tpu.nn import conv as jconv
from audiocraft_tpu_torch.builders import get_debug_compression_model, get_encodec_32khz
from audiocraft_tpu_torch.ckpt.from_jax import encodec_state_from_jax
from audiocraft_tpu_torch.nn import conv as tconv

GOLDENS = Path(__file__).parent / "goldens"
ASSETS = ("a_duck_quacking_as_birds_chirp_and_a_pig", "bach", "bolero_ravel",
          "sirens_and_a_humming_engine_approach_and")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _load_port(model, params):
    model.load_state_dict(encodec_state_from_jax(model, _np_tree(params)))
    return model


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k,stride,dilation,causal,length", [
    (7, 1, 1, False, 101),   # odd length
    (3, 1, 4, False, 50),    # dilated residual conv
    (8, 4, 1, False, 37),    # strided, extra right padding
    (10, 5, 1, True, 64),    # causal
    (7, 1, 1, False, 3),     # shorter than the reflect pad
    (16, 8, 1, True, 5),     # causal, shorter than the pad
])
def test_conv1d_matches_jax(k, stride, dilation, causal, length):
    rng = np.random.RandomState(k * 100 + length)
    x = rng.randn(2, 3, length).astype(np.float32)
    jmod = jconv.StreamableConv1d(3, 5, k, stride=stride, dilation=dilation, causal=causal)
    params = _np_tree(jmod.init(jax.random.PRNGKey(k)))
    tmod = tconv.StreamableConv1d(3, 5, k, stride=stride, dilation=dilation, causal=causal)
    tmod.conv['conv']['weight'].data = _t(params['weight'])
    tmod.conv['conv']['bias'].data = _t(params['bias'])
    ref = np.asarray(jmod(params, jnp.asarray(x)))
    out = tmod(_t(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,stride,causal,trim_right_ratio,length", [
    (16, 8, False, 1.0, 9),
    (10, 5, False, 1.0, 4),
    (8, 4, True, 1.0, 7),
    (8, 4, True, 0.5, 7),
])
def test_conv_transpose1d_matches_jax(k, stride, causal, trim_right_ratio, length):
    x = np.random.RandomState(k + length).randn(2, 4, length).astype(np.float32)
    jmod = jconv.StreamableConvTranspose1d(4, 3, k, stride=stride, causal=causal,
                                           trim_right_ratio=trim_right_ratio)
    params = _np_tree(jmod.init(jax.random.PRNGKey(k)))
    tmod = tconv.StreamableConvTranspose1d(4, 3, k, stride=stride, causal=causal,
                                           trim_right_ratio=trim_right_ratio)
    tmod.convtr['convtr']['weight'].data = _t(params['weight'])
    tmod.convtr['convtr']['bias'].data = _t(params['bias'])
    ref = np.asarray(jmod(params, jnp.asarray(x)))
    out = tmod(_t(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def debug_pair():
    jmodel = jax_debug_model(32000)
    with np.load(GOLDENS / "debug_codec_state.npz") as data:
        sd = {k: data[k] for k in data.files}
    params = import_encodec(jmodel, sd)
    port = _load_port(get_debug_compression_model(32000, device='cpu'), params)
    return jmodel, jax.tree.map(jnp.asarray, params), port


def test_debug_seanet_encoder_decoder_match_jax(debug_pair):
    jmodel, params, port = debug_pair
    x = np.random.RandomState(0).randn(2, 1, 6400).astype(np.float32) * 0.3
    ref = np.asarray(jmodel.encoder(params['encoder'], jnp.asarray(x)))
    emb = port.encoder(_t(x))
    np.testing.assert_allclose(emb.numpy(), ref, rtol=1e-5, atol=1e-5)
    z = np.random.RandomState(1).randn(2, 32, 5).astype(np.float32)
    ref = np.asarray(jmodel.decoder(params['decoder'], jnp.asarray(z)))
    out = port.decoder(_t(z)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ASSETS)
def test_port_reproduces_golden_tokens(debug_pair, name):
    """Twin of tests/test_goldens.py:test_codec_tokens_match_goldens."""
    _, _, port = debug_pair
    with np.load(GOLDENS / "asset_tokens.npz") as assets:
        pcm, tokens = assets[name + "__pcm"], assets[name]
    codes, scale = port.encode(_t(pcm))
    assert scale is None and codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), tokens)


def test_set_num_codebooks_keeps_a_prefix_of_the_codes(debug_pair):
    _, _, port = debug_pair
    wav = _t(np.random.RandomState(2).randn(1, 1, 12800).astype(np.float32) * 0.3)
    full, _ = port.encode(wav)
    port.set_num_codebooks(2)
    try:
        two, _ = port.encode(wav)
    finally:
        port.set_num_codebooks(4)
    np.testing.assert_array_equal(two.numpy(), full[:, :2].numpy())
    assert port.decode(two).shape == (1, 1, 12800)


def test_state_dict_round_trips_through_import_encodec(debug_pair):
    """The port's names are the reference layout that import_encodec reads."""
    jmodel, params, port = debug_pair
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = import_encodec(jmodel, sd)
    flat_ref, tree_ref = jax.tree.flatten(_np_tree(params))
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(np.asarray(a).reshape(np.shape(b)), b)


@pytest.fixture(scope="module")
def full_pair():
    """The published 32 kHz widths on shared weights from the JAX init, with
    random codebooks (the JAX init leaves them zero until k-means)."""
    jmodel = jax_encodec_32khz(compute_dtype=None)
    params = _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    q = params['quantizer']
    # codebooks at the scale of the random-init latent (std about 0.03)
    embed = np.random.RandomState(3).randn(*q.embed.shape).astype(np.float32) * 0.03
    params['quantizer'] = dict(embed=embed, cluster_size=np.asarray(q.cluster_size),
                               embed_avg=embed, inited=np.ones_like(q.inited))
    port = _load_port(get_encodec_32khz(compute_dtype=None, device='cpu'), params)
    return jmodel, jax.tree.map(jnp.asarray, params), port


def test_full_width_fp32_codes_equal_jax(full_pair):
    jmodel, params, port = full_pair
    wav = np.random.RandomState(0).randn(2, 1, 64000).astype(np.float32) * 0.2
    ref, _ = jmodel.encode(params, jnp.asarray(wav))
    codes, _ = port.encode(_t(wav))
    assert codes.shape == (2, 4, 100)
    assert len(np.unique(codes.numpy())) > 50  # not a degenerate codebook
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))


def test_full_width_fp32_decode_matches_jax(full_pair):
    jmodel, params, port = full_pair
    codes = np.random.RandomState(1).randint(0, 2048, size=(1, 4, 50)).astype(np.int32)
    ref = np.asarray(jmodel.decode(params, jnp.asarray(codes)))
    wav = port.decode(_t(codes)).numpy()
    assert wav.shape == ref.shape == (1, 1, 32000)
    assert np.abs(wav - ref).max() < 2e-4


def test_full_width_bf16_latent_matches_jax_kernel_numerics(full_pair):
    """bf16 encoder latent vs the JAX encoder with its LSTM kernel (interpret
    mode, B = 8 so the kernel takes the shape): both keep gates and c in
    fp32.  The two conv libraries round bf16 at other places; the measured
    relative error is 8.5e-3, held here at 5e-2."""
    jmodel, params, port = full_pair
    wav = np.random.RandomState(4).randn(8, 1, 6400).astype(np.float32) * 0.2
    enc = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params['encoder'])
    ref = np.asarray(jmodel.encoder(enc, jnp.asarray(wav, jnp.bfloat16), lstm_kernel=True,
                                    interpret=True).astype(jnp.float32))
    with torch.no_grad():
        emb = port.encoder(_t(wav).bfloat16()).float().numpy()
    assert emb.shape == ref.shape == (8, 128, 10)
    rel = np.abs(emb - ref).max() / np.abs(ref).max()
    assert rel < 5e-2, rel


@pytest.mark.parametrize("compute_dtype,inside", [(None, False), ("bfloat16", True)])
def test_fp32_codec_turns_cudnn_tf32_off_and_restores_it(compute_dtype, inside):
    """torch runs fp32 convolutions in TF32 on the card by default: the fp32
    codec turns cuDNN's TF32 off around its conv stacks, leaves a bf16 codec
    alone, and gives the caller's flag back."""
    model = get_debug_compression_model(32000, device='cpu')
    model.compute_dtype = compute_dtype
    seen = []
    hooks = [stack.model[0].register_forward_pre_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
        for stack in (model.encoder, model.decoder)]
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        wav = torch.from_numpy(np.random.RandomState(0).randn(1, 1, 1280).astype(np.float32))
        codes, _ = model.encode(wav)
        model.decode(codes)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
        for hook in hooks:
            hook.remove()
    assert seen == [inside, inside]
