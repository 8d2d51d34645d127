"""The PyTorch port's SEANet kernels (K4 fused stage, K5 and K6 mono input
conv), the fused-encode route, the 24 kHz codec and the data-movement probe
(P1) against the JAX package, on the CPU.

The port runs its kernels' plain versions here; the JAX side runs its Pallas
kernels in interpret mode.  Inputs come from a seed with numpy, weights from
the JAX package's init through ``ckpt/from_jax.py``.  Tolerances: 1e-5
relative where both sides compute in fp32 (summation order only); 1e-2 of
the max in bf16 against JAX's fused kernel (the same rounding points) and
3e-2 against its unfused stack (other rounding points), the JAX tests' own;
codes exactly equal in fp32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.builders import get_debug_compression_model as jax_debug_model
from audiocraft_tpu.builders import get_encodec_24khz as jax_encodec_24khz
from audiocraft_tpu.builders import get_encodec_32khz as jax_encodec_32khz
from audiocraft_tpu.codec.encodec import _q_state
from audiocraft_tpu.nn import conv as jconv
from audiocraft_tpu.ops import seanet_pallas as jsp
from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.apps import probe_ops
from audiocraft_tpu_torch.ckpt.from_jax import seanet_state_from_jax
from audiocraft_tpu_torch.nn.conv import pad1d
from audiocraft_tpu_torch.ops import probe
from audiocraft_tpu_torch.ops import seanet as tsp

BF16 = jnp.bfloat16


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(out, ref):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-6)


def _cast(tree, dtype):
    return jax.tree.map(lambda a: a.astype(dtype)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _codec_pair(jmodel, port, seed):
    """The JAX encoder's init (jitted) carried into the port's encoder, and
    random codebooks at the scale of the random-init latent in both
    quantizers (the JAX init leaves them zero).  Returns the JAX params of
    the encoder and the quantizer."""
    enc = jax.tree.map(np.asarray, jax.jit(jmodel.encoder.init)(jax.random.PRNGKey(seed)))
    port.encoder.load_state_dict(seanet_state_from_jax(port.encoder, enc))
    q = jmodel.quantizer
    embed = np.random.RandomState(seed).randn(q.n_q, q.bins, q.dimension).astype(np.float32)
    embed *= 0.03
    for layer, e in zip(port.quantizer.vq.layers, embed):
        layer._codebook.embed.copy_(_t(e))
    state = dict(embed=embed, cluster_size=np.zeros(embed.shape[:2], np.float32),
                 embed_avg=embed, inited=np.ones(q.n_q, np.float32))
    return jax.tree.map(jnp.asarray, dict(encoder=enc, quantizer=state))


def _jax_encoder(jmodel, params, x, dtype=jnp.float32, **route):
    """The JAX encoder under jit (one compile instead of one per op), with
    its Pallas kernels in interpret mode."""
    fn = jax.jit(lambda p, x: jmodel.encoder(p, x, interpret=True, **route))
    return fn(_cast(params['encoder'], dtype), jnp.asarray(x, dtype))


def _jax_codes(jmodel, params, x, **route):
    emb = _jax_encoder(jmodel, params, x, **route)
    return np.asarray(jmodel.quantizer.encode(_q_state(jmodel.quantizer, params['quantizer']),
                                              emb))


@pytest.fixture(scope="module")
def codec_32k():
    """get_encodec_32khz(compute_dtype=None) in both packages on shared
    weights; its encoder serves every SEANet test below (stage 0: c = 64,
    s = 4; stage 1: c = 128, s = 4; then s = 5 and s = 8)."""
    jmodel = jax_encodec_32khz(compute_dtype=None)
    port = builders.get_encodec_32khz(compute_dtype=None, device='cpu')
    return jmodel, _codec_pair(jmodel, port, 0), port


def _jax_layers(jmodel, params, x, lo, hi):
    """JAX's unfused module stack over layers lo..hi, [B, C, T] in and out."""
    def run(p, x):
        for i, (kind, mod) in enumerate(jmodel.encoder._layers()):
            if lo <= i <= hi:
                x = jax.nn.elu(x) if kind == 'act' else mod(p[f'layer{i}'], x)
        return x
    return np.asarray(jax.jit(run)(params['encoder'], jnp.asarray(x)))


# ----------------------------------------------------------------- K4

@pytest.fixture(scope="module")
def stage_bf16(codec_32k):
    """JAX fused_stage (interpret) on stage 1 (c = 128, s = 4) in bf16 and
    the port's plain version on the same weights and input."""
    jmodel, params, port = codec_32k
    jspec = jsp.StageSpec(c_in=128, c_out=256, stride=4)
    spec = tsp.StageSpec(c_in=128, c_out=256, stride=4)
    x = np.random.RandomState(0).randn(2, 128, 64 * 4 * 4).astype(np.float32) * 0.5
    kp = jsp.stage_params_from_tree(params['encoder'], jspec, [4, 6])
    ref = jax.jit(lambda x, kp: jsp.fused_stage(x, kp, jspec, tile=64, interpret=True))(
        jnp.swapaxes(jnp.asarray(x, BF16), 1, 2), kp)
    out = tsp.fused_stage(_t(x, torch.bfloat16),
                          tsp.stage_params(port.encoder, spec, [4, 6], torch.bfloat16), spec)
    return out, jnp.swapaxes(ref, 1, 2)


@pytest.mark.parametrize("frames", [slice(None), slice(0, 4), slice(-4, None)],
                         ids=["all", "first4", "last4"])
def test_fused_stage_bf16_matches_jax_kernel(stage_bf16, frames):
    """The rounding points match the TPU kernel's, so the bf16 outputs agree
    to 1e-2 of the max, the reflect-padded edges included."""
    out, ref = stage_bf16
    assert out.shape == (2, 256, 256) and out.dtype == torch.bfloat16
    assert _rel(out[..., frames], _np(ref)[..., frames]) < 1e-2


@pytest.mark.parametrize("stride,ids,c", [(4, [1, 3], 64), (5, [7, 9], 256), (8, [10, 12], 512)])
def test_fused_stage_fp32_matches_jax_layers(codec_32k, stride, ids, c):
    """fp32: the fused stage equals JAX's unfused layers up to summation
    order, at every stride, frames not a multiple of any tile, edges too."""
    jmodel, params, port = codec_32k
    spec = tsp.StageSpec(c_in=c, c_out=2 * c, stride=stride)
    x = np.random.RandomState(stride).randn(1, c, stride * 37).astype(np.float32) * 0.5
    ref = _jax_layers(jmodel, params, x, ids[0], ids[1])
    out = tsp.fused_stage(_t(x), tsp.stage_params(port.encoder, spec, ids, torch.float32), spec)
    assert out.shape == ref.shape == (1, 2 * c, 37)
    for frames in (slice(None), slice(0, 4), slice(-4, None)):
        assert _rel(out[..., frames], ref[..., frames]) < 1e-5


def test_stage_a_matches_jax_input_conv_and_fused_stage(codec_32k):
    """The production stage-A path: the port's conv0 (the module's own) and
    stage 0 at c = 64 against JAX's NWC conv0 padded to 128 lanes and its
    padded-input fused kernel, bf16."""
    jmodel, params, port = codec_32k
    p = params['encoder']
    jspec = jsp.StageSpec(c_in=64, c_out=128, stride=4, input_padded=True)
    x = np.random.RandomState(2).randn(2, 1, 4 * 64 * 4).astype(np.float32) * 0.4

    def stage_a(x, p):
        a = jsp.nwc_input_conv(jnp.swapaxes(x, 1, 2), p['layer0']['weight'],
                               p['layer0']['bias'], jspec.c_pad)
        kp = jsp.stage_params_from_tree(p, jspec, [1, 3])
        return jnp.swapaxes(jsp.fused_stage(a, kp, jspec, tile=64, interpret=True), 1, 2)
    ref = _np(jax.jit(stage_a)(jnp.asarray(x, BF16), p))
    spec = tsp.encoder_stage_plan(port.encoder)[0][0]
    assert spec == tsp.StageSpec(c_in=64, c_out=128, stride=4, input_padded=True)
    with torch.no_grad():
        a_t = port.encoder.model[0](_t(x, torch.bfloat16))
    out = tsp.fused_stage(a_t, tsp.stage_params(port.encoder, spec, [1, 3], torch.bfloat16),
                          spec)
    for frames in (slice(None), slice(0, 4), slice(-4, None)):
        assert _rel(out[..., frames], ref[..., frames]) < 1e-2


# ------------------------------------------------------ the fused encoder

@pytest.fixture(scope="module")
def fused_fp32(codec_32k):
    """The whole fp32 encoder with fused_stages=2 in both packages."""
    jmodel, params, port = codec_32k
    x = np.random.RandomState(7).randn(2, 1, 640 * 8).astype(np.float32) * 0.3
    ref = _np(_jax_encoder(jmodel, params, x, fused_stages=2))
    with torch.no_grad():
        out = port.encoder(_t(x), fused_stages=2)
    return out, ref


def test_fused_encoder_fp32_latent_matches_jax(fused_fp32):
    out, ref = fused_fp32
    assert out.shape == ref.shape == (2, 128, 8)
    assert _rel(out, ref) < 1e-5


def test_fused_encoder_fp32_codes_equal_jax(codec_32k, fused_fp32):
    """Both latents through the port's quantizer: the same codes."""
    out, ref = fused_fp32
    _, _, port = codec_32k
    codes, codes_ref = port.quantizer.encode(out), port.quantizer.encode(_t(ref))
    assert len(np.unique(codes_ref.numpy())) > 8
    np.testing.assert_array_equal(codes.numpy(), codes_ref.numpy())


@pytest.mark.parametrize("route", ["fused", "conv0_kernel_and_fused"])
def test_front_bf16_matches_jax_unfused(codec_32k, route):
    """bf16, the layers before the LSTM, against JAX's unfused stack at its
    own tolerance.  With conv0_kernel the input conv runs K5 and consumes
    layer 0, so the fused prefix (which runs its own input conv on the raw
    signal) must stand aside: layer 0 applies once, and the encoder with
    both flags equals the encoder with conv0_kernel alone."""
    jmodel, params, port = codec_32k
    stop = jmodel.encoder.split_index
    x = np.random.RandomState(8).randn(2, 1, 640 * 8).astype(np.float32) * 0.3
    ref = _jax_encoder(jmodel, params, x, BF16, stop_layer=stop)
    enc, xt = port.encoder, _t(x, torch.bfloat16)
    with torch.no_grad():
        if route == 'fused':
            out, start = tsp.fused_encoder_apply(enc, xt, 2)
            assert start == 7
        else:
            out, start = enc._conv0_kernel(xt), 1
            assert torch.equal(enc(xt, fused_stages=2, conv0_kernel=True),
                               enc(xt, conv0_kernel=True))
        for layer in enc.model[start:stop]:
            out = layer(out)
    assert out.dtype == torch.bfloat16
    assert _rel(out, ref) < 3e-2


def test_fused_route_declines_a_length_off_the_stride(codec_32k):
    """L % s != 0 is the JAX route's own rule: the module stack runs."""
    _, _, port = codec_32k
    x = _t(np.random.RandomState(4).randn(1, 1, 1282).astype(np.float32) * 0.3)
    assert tsp.fused_encoder_apply(port.encoder, x, 2) is None


@pytest.mark.parametrize("config", ["32khz", "24khz", "debug"])
def test_stage_plan_equals_jax(config):
    jmodel = {'32khz': jax_encodec_32khz, '24khz': jax_encodec_24khz,
              'debug': jax_debug_model}[config]()
    model = {'32khz': builders.get_encodec_32khz, '24khz': builders.get_encodec_24khz,
             'debug': builders.get_debug_compression_model}[config](device='cpu')
    key = lambda spec: (spec.c_in, spec.c_out, spec.stride, spec.res_hidden,
                        spec.input_padded, spec.left_pad, spec.right_pad)
    ours = [(key(spec), ids) for spec, ids in tsp.encoder_stage_plan(model.encoder)]
    theirs = [(key(spec), ids) for spec, ids in jsp.encoder_stage_plan(jmodel.encoder)]
    assert ours == theirs
    assert bool(ours) == (config != '24khz')


# ------------------------------------------------------------- K5, K6

@pytest.fixture(scope="module")
def conv0(codec_32k):
    jmodel, params, _ = codec_32k
    p0 = _cast(params['encoder']['layer0'], BF16)
    return jmodel.encoder, p0, _t(_np(p0['weight']), torch.bfloat16), _t(_np(p0['bias']),
                                                                        torch.bfloat16)


@pytest.mark.parametrize("kernel", ["banded_mono_conv", "mono_input_conv"])
def test_mono_conv_bf16_matches_jax_kernel(conv0, kernel):
    _, p0, w, b = conv0
    x = jnp.asarray(np.random.RandomState(8).randn(2, 1, 128 * 25) * 0.4, BF16)
    if kernel == 'banded_mono_conv':
        x = jconv.pad1d(x, (3, 3), mode='reflect')
        ref = jsp.banded_mono_conv(x, p0['weight'], p0['bias'], interpret=True)
    else:
        ref = jsp.mono_input_conv(x, p0['weight'], p0['bias'], tile_rows=16, interpret=True)
    out = getattr(tsp, kernel)(_t(_np(x), torch.bfloat16), w, b)
    assert out.shape == ref.shape == (2, 64, 128 * 25)
    for frames in (slice(None), slice(0, 8), slice(-8, None)):
        assert _rel(out[..., frames], _np(ref)[..., frames]) < 1e-2


@pytest.mark.parametrize("kernel", ["banded_mono_conv", "mono_input_conv"])
def test_mono_conv_takes_lengths_the_tpu_kernel_declines(conv0, kernel):
    """T = 1000 is no multiple of 128: JAX declines its kernels there, the
    port's take it; held against JAX's module conv."""
    jenc, p0, w, b = conv0
    x = jnp.asarray(np.random.RandomState(6).randn(1, 1, 1000) * 0.4, BF16)
    assert jsp.mono_input_conv(x, p0['weight'], p0['bias'], interpret=True) is None
    ref = jenc._layers()[0][1](p0, x)
    xt = _t(_np(x), torch.bfloat16)
    if kernel == 'banded_mono_conv':
        xt = pad1d(xt, (3, 3), 'reflect')
    out = getattr(tsp, kernel)(xt, w, b)
    assert _rel(out, ref) < 1e-2
    assert _rel(out[..., -8:], _np(ref)[..., -8:]) < 1e-2


# ------------------------------------------------- the codec entry points

@pytest.mark.parametrize("route", ["fused", "conv0_kernel"])
def test_encode_routes_give_jax_codes(codec_32k, route):
    """encode(fused=True) and encode(conv0_kernel=True) of the fp32 32 kHz
    codec: the JAX encoder on the same route (interpret) and its quantizer
    give the same codes."""
    jmodel, params, port = codec_32k
    x = np.random.RandomState(10).randn(1, 1, 32000).astype(np.float32) * 0.2
    ref = _jax_codes(jmodel, params, x, **({'fused_stages': 2} if route == 'fused'
                                           else {'conv0_kernel': True}))
    codes, _ = port.encode(_t(x), **{route: True})
    assert codes.shape == (1, 4, 50)
    assert len(np.unique(codes.numpy())) > 20
    np.testing.assert_array_equal(codes.numpy(), ref)


@pytest.fixture(scope="module")
def codec_24k():
    jmodel = jax_encodec_24khz()
    port = builders.get_encodec_24khz(device='cpu')
    return jmodel, _codec_pair(jmodel, port, 1), port


@pytest.mark.parametrize("route", ["default", "conv0_kernel"])
def test_encodec_24khz_codes_equal_jax(codec_24k, route):
    """The causal 24 kHz config: the stage plan declines it; conv0_kernel
    runs K5 with all of the causal padding on the left."""
    jmodel, params, port = codec_24k
    assert port.encoder.causal and port.frame_rate == 75 and port.quantizer.n_q == 8
    x = np.random.RandomState(11).randn(1, 1, 5120).astype(np.float32) * 0.2
    kw = {'conv0_kernel': True} if route == 'conv0_kernel' else {}
    ref = _jax_codes(jmodel, params, x, **kw)
    codes, scale = port.encode(_t(x), **kw)
    assert scale is None and codes.shape == (1, 8, 16)
    assert len(np.unique(codes.numpy())) > 20
    np.testing.assert_array_equal(codes.numpy(), ref)


# ------------------------------------------------------------------ P1

_PROBE_CASES = {
    'merge 512x64->128x256': ((512, 64), lambda x: probe.reshape(x, (128, 256)),
                              lambda a: a.reshape(128, 256)),
    'merge 512x128->128x512': ((512, 128), lambda x: probe.reshape(x, (128, 512)),
                               lambda a: a.reshape(128, 512)),
    '3d split + dot_general': ((512, 64), None, None),
    'lane stride [:, ::4]': ((512, 128), lambda x: probe.strided_slice(x, 1, 4),
                             lambda a: a[:, ::4]),
    'sublane stride [::4, :]': ((512, 128), lambda x: probe.strided_slice(x, 4, 1),
                                lambda a: a[::4, :]),
    'merge 520x64->130x256': ((520, 64), lambda x: probe.reshape(x, (130, 256)),
                              lambda a: a.reshape(130, 256)),
    'split 512x64->4x128x64': ((512, 64), lambda x: probe.reshape(x, (4, 128, 64)),
                               lambda a: a.reshape(4, 128, 64)),
}


@pytest.mark.parametrize("name", list(_PROBE_CASES))
def test_probe_plain_versions_equal_numpy(name):
    shape, op, ref = _PROBE_CASES[name]
    rng = np.random.RandomState(len(name))
    a = rng.randn(*shape).astype(np.float32)
    x = torch.from_numpy(a).bfloat16()
    a = x.float().numpy()                     # the bf16-rounded values
    if op is None:
        taps = torch.from_numpy(rng.randn(4, 64, 32).astype(np.float32)).bfloat16()
        out = probe.split_contract(x, taps)
        want = np.einsum('msc,scn->mn', a.reshape(128, 4, 64), taps.float().numpy())
        assert out.dtype == torch.bfloat16 and out.shape == (128, 32)
        np.testing.assert_allclose(out.float().numpy(), want, rtol=2 ** -8, atol=1e-5)
    else:
        out = op(x)
        np.testing.assert_array_equal(out.float().numpy(), ref(a))


def test_probe_app_prints_ok_for_each_operation(capsys):
    assert probe_ops.main(['--device', 'cpu']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 7 and all(': OK ' in line for line in lines)


# ------------------------------------------------- wrappers and layouts

def test_wrappers_raise_on_meta_tensors_and_bad_shapes():
    spec = tsp.StageSpec(c_in=16, c_out=32, stride=4)
    params = {k: torch.zeros(s) for k, s in dict(w1=(48, 8), b1=(8,), w2=(8, 16), b2=(16,),
                                                  wd=(128, 32), bd=(32,)).items()}
    w, b = torch.zeros(64, 1, 7), torch.zeros(64)
    meta = lambda *shape: torch.empty(*shape, device='meta')
    calls = [
        lambda: tsp.fused_stage(meta(1, 16, 64), params, spec),
        lambda: tsp.fused_stage(torch.zeros(1, 16, 66), params, spec),    # L % s
        lambda: tsp.fused_stage(torch.zeros(1, 8, 64), params, spec),     # channels
        lambda: tsp.fused_stage(torch.zeros(1, 16, 64).bfloat16(), params, spec),  # dtypes
        lambda: tsp.banded_mono_conv(meta(1, 1, 70), w, b),
        lambda: tsp.banded_mono_conv(torch.zeros(1, 2, 70), w, b),
        lambda: tsp.banded_mono_conv(torch.zeros(1, 1, 5), w, b),          # shorter than k
        lambda: tsp.mono_input_conv(meta(1, 1, 64), w, b),
        lambda: tsp.mono_input_conv(torch.zeros(1, 1, 64), torch.zeros(64, 1, 6), b),
        lambda: tsp.mono_input_conv(torch.zeros(1, 1, 3), w, b),           # T <= pad
        lambda: probe.gather(meta(8, 8).bfloat16(), 2, 2, 1, 1),
        lambda: probe.gather(torch.zeros(8, 8).bfloat16(), 8, 8, 8, 2),    # past the end
        lambda: probe.split_contract(torch.zeros(8, 8).bfloat16(),
                                     torch.zeros(3, 8, 4).bfloat16()),
        lambda: probe.reshape(torch.zeros(8, 8).bfloat16(), (3, 20)),
    ]
    for i, call in enumerate(calls):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"call {i} did not raise")


def test_mma_fragment_packing_is_the_b_fragment_order():
    """The tensor cores read B[k, n] of 16-deep chunk kc at byte (ng * 2 +
    h) * 128 + j * 16 + i * 2 of the chunk (n = 8 ng + j, k = 16 kc + 8 h +
    i): 8-column core matrices, K-major, the two 8-deep halves 128 bytes
    apart, the column groups 256 bytes apart (the descriptor's strides)."""
    w = torch.arange(64 * 24, dtype=torch.float32).reshape(64, 24)
    flat = tsp.pack_b_tiles(w).reshape(-1)
    for k in range(64):
        for n in range(24):
            kc, h, i = k // 16, k // 8 % 2, k % 8
            ng, j = divmod(n, 8)
            byte = kc * 24 * 32 + (ng * 2 + h) * 128 + j * 16 + i * 2
            assert flat[byte // 2] == w[k, n]
    for shape in ((24, 16), (32, 12)):
        with pytest.raises(ValueError):
            tsp.pack_b_tiles(torch.zeros(shape))
