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


# ------------------------------------------------ time_group_norm, final_activation, API
@pytest.mark.parametrize("causal,length", [(False, 37), (True, 64)])
def test_time_group_norm_conv_matches_jax(causal, length):
    """GroupNorm(1, C) after the conv, its scale and bias at the reference
    names ``conv.norm.weight`` / ``conv.norm.bias``, fp32 at 1e-5."""
    rng = np.random.RandomState(length)
    x = rng.randn(2, 3, length).astype(np.float32)
    jmod = jconv.StreamableConv1d(3, 5, 4, stride=2, causal=causal, norm='time_group_norm')
    params = _np_tree(jmod.init(jax.random.PRNGKey(length)))
    params['gn_scale'] = rng.randn(5).astype(np.float32)
    params['gn_bias'] = rng.randn(5).astype(np.float32)
    tmod = tconv.StreamableConv1d(3, 5, 4, stride=2, causal=causal, norm='time_group_norm')
    assert sorted(tmod.state_dict()) == ['conv.conv.bias', 'conv.conv.weight',
                                         'conv.norm.bias', 'conv.norm.weight']
    tmod.load_state_dict({'conv.conv.weight': _t(params['weight']),
                          'conv.conv.bias': _t(params['bias']),
                          'conv.norm.weight': _t(params['gn_scale']),
                          'conv.norm.bias': _t(params['gn_bias'])})
    ref = np.asarray(jmod(params, jnp.asarray(x)))
    np.testing.assert_allclose(tmod(_t(x)).detach().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_seanet_time_group_norm_and_final_activation_match_jax():
    """A SEANet encoder and decoder with ``time_group_norm`` convs and a
    ``Tanh`` final activation, carried from the JAX init through
    ``seanet_state_from_jax`` (which moves ``gn_scale`` / ``gn_bias``);
    the fused stage plan and K5's route decline the norm, as JAX's do."""
    from audiocraft_tpu.nn import seanet as jseanet
    from audiocraft_tpu_torch.ckpt.from_jax import seanet_state_from_jax
    from audiocraft_tpu_torch.nn import seanet as tseanet
    from audiocraft_tpu_torch.ops.seanet import encoder_stage_plan

    cfg = dict(channels=1, dimension=8, n_filters=4, n_residual_layers=1, ratios=(4, 2),
               norm='time_group_norm', lstm=1)
    rng = np.random.RandomState(11)

    def with_gn(tree):   # the init leaves scale 1 and bias 0: move them
        if isinstance(tree, dict):
            out = {k: with_gn(v) for k, v in tree.items()}
            if 'gn_scale' in out:
                out['gn_scale'] = 1 + 0.3 * rng.randn(*out['gn_scale'].shape).astype(np.float32)
                out['gn_bias'] = 0.3 * rng.randn(*out['gn_bias'].shape).astype(np.float32)
            return out
        return tree

    jenc = jseanet.SEANetEncoder(**cfg)
    jdec = jseanet.SEANetDecoder(**cfg, final_activation='Tanh')
    penc = with_gn(_np_tree(jax.jit(jenc.init)(jax.random.PRNGKey(1))))
    pdec = with_gn(_np_tree(jax.jit(jdec.init)(jax.random.PRNGKey(2))))
    tenc = tseanet.SEANetEncoder(**cfg)
    tdec = tseanet.SEANetDecoder(**cfg, final_activation='Tanh')
    tenc.load_state_dict(seanet_state_from_jax(tenc, penc))
    tdec.load_state_dict(seanet_state_from_jax(tdec, pdec))
    x = rng.randn(2, 1, 96).astype(np.float32)
    with torch.no_grad():
        emb = tenc(_t(x))
        np.testing.assert_allclose(emb.numpy(), np.asarray(jenc(penc, jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)
        out = tdec(emb)
    ref = np.asarray(jdec(pdec, jnp.asarray(emb.numpy())))
    assert out.shape == ref.shape == (2, 1, 96) and np.abs(ref).max() < 1
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert encoder_stage_plan(tenc) == [] and tenc._conv0_kernel(_t(x)) is None


def test_encodec_api_matches_jax(debug_pair):
    """total_codebooks, num_codebooks, cardinality, encode_to_latent and the
    per-call compute_dtype (and lstm_kernel, which selects nothing) against
    the JAX model's."""
    jmodel, params, port = debug_pair
    assert (port.total_codebooks, port.num_codebooks, port.cardinality) == (
        jmodel.total_codebooks, jmodel.num_codebooks, jmodel.cardinality) == (4, 4, 400)
    port.set_num_codebooks(3)
    try:
        assert (port.total_codebooks, port.num_codebooks) == (
            4, jmodel.set_num_codebooks(3).num_codebooks) == (4, 3)
    finally:
        port.set_num_codebooks(4)
    wav = np.random.RandomState(12).randn(2, 1, 12800).astype(np.float32) * 0.3
    ref = np.asarray(jmodel.encode_to_latent(params, jnp.asarray(wav)))
    lat = port.encode_to_latent(_t(wav))
    assert lat.dtype == torch.float32 and lat.shape == ref.shape == (2, 32, 10)
    np.testing.assert_allclose(lat.numpy(), ref, rtol=1e-5, atol=1e-5)
    codes, _ = port.encode(_t(wav), compute_dtype=torch.float32, lstm_kernel=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jmodel.encode(
        params, jnp.asarray(wav), lstm_kernel=False)[0]))
    out = port.decode(codes, compute_dtype='float32', lstm_kernel=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jmodel.decode(
        params, jnp.asarray(codes.numpy()))), rtol=1e-5, atol=1e-5)


def test_per_call_bf16_matches_jax(full_pair):
    """``compute_dtype='bfloat16'`` per call on an fp32 codec at the 32 kHz
    widths: the latent and the waveform against JAX's bf16 calls (the two
    conv libraries round bf16 at other places: 5e-2 relative, as above).
    The debug codec is not used here: torch's CPU bf16 conv at its stride
    16 and kernel 32 is off by most of its output."""
    jmodel, params, port = full_pair
    wav = np.random.RandomState(14).randn(2, 1, 6400).astype(np.float32) * 0.2
    ref = np.asarray(jmodel.encode_to_latent(params, jnp.asarray(wav),
                                             compute_dtype=jnp.bfloat16))
    lat = port.encode_to_latent(_t(wav), compute_dtype='bfloat16')
    assert lat.dtype == torch.float32 and lat.shape == ref.shape == (2, 128, 10)
    assert np.abs(lat.numpy() - ref).max() / np.abs(ref).max() < 5e-2
    assert not np.array_equal(lat.numpy(), port.encode_to_latent(_t(wav)).numpy())
    codes = np.random.RandomState(15).randint(0, 2048, size=(1, 4, 10)).astype(np.int32)
    ref = np.asarray(jmodel.decode(params, jnp.asarray(codes), compute_dtype=jnp.bfloat16))
    out = port.decode(_t(codes), compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (1, 1, 6400)
    assert np.abs(out.numpy() - ref).max() / np.abs(ref).max() < 5e-2


def test_default_route_on_the_cpu_stays_off(debug_pair, monkeypatch):
    """On a CPU tensor ``encode(fused=None)`` runs the module stack, as the
    JAX package's default does; ``fused=True`` takes the fused route."""
    from audiocraft_tpu_torch.nn import seanet as tseanet

    _, _, port = debug_pair
    wav = _t(np.random.RandomState(13).randn(1, 1, 12800).astype(np.float32) * 0.3)
    assert not port.fused_default(wav)
    calls = []
    real = tseanet.fused_encoder_apply
    monkeypatch.setattr(tseanet, 'fused_encoder_apply',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    default, _ = port.encode(wav)
    assert calls == []
    fused, _ = port.encode(wav, fused=True)
    assert calls == [1]
    np.testing.assert_array_equal(fused.numpy(), default.numpy())
