"""The port's streaming codec (``codec/streaming.py``) against the JAX
package's, on the CPU.

A tiny causal codec and the published 24 kHz topology at a thin width, with
the JAX init carried across (random codebooks, which the JAX init leaves at
zero) and inputs made by numpy from a seed.  Codes compare exactly, chunk for
chunk, and against the whole-signal encode; streamed audio within 1e-5 of
JAX's stream and of the whole decode (fp32; the convs sum in another order
at a chunk's length).  The LSTM carries its (h, c) through the kernel's
plain version here.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.builders import get_encodec_24khz as jax_encodec_24khz
from audiocraft_tpu.codec import streaming as jstreaming
from audiocraft_tpu.codec.encodec import EncodecModel as JaxEncodec
from audiocraft_tpu.nn.seanet import SEANetDecoder as JaxDecoder
from audiocraft_tpu.nn.seanet import SEANetEncoder as JaxEncoder
from audiocraft_tpu.quant.vq import ResidualVectorQuantizer as JaxRVQ
from audiocraft_tpu_torch.builders import get_encodec_24khz
from audiocraft_tpu_torch.ckpt.from_jax import encodec_state_from_jax
from audiocraft_tpu_torch.codec import streaming
from audiocraft_tpu_torch.codec.encodec import EncodecModel
from audiocraft_tpu_torch.nn.seanet import SEANetDecoder, SEANetEncoder
from audiocraft_tpu_torch.quant.vq import ResidualVectorQuantizer


def _random_codebooks(jmodel, params, seed):
    """Codebook q takes random latent frames of a seeded signal, scaled by
    2^-q, so that the codes spread over each codebook."""
    q = params['quantizer']
    rng = np.random.RandomState(seed)
    lat = np.asarray(jax.jit(jmodel.encoder)(params['encoder'], jnp.asarray(
        rng.randn(4, 1, 64 * jmodel.encoder.hop_length).astype(np.float32) * 0.4)))
    frames = lat.transpose(0, 2, 1).reshape(-1, lat.shape[1])
    n_q, bins, _ = np.shape(q.embed)
    embed = np.stack([frames[rng.randint(0, len(frames), bins)] * 0.5 ** k
                      for k in range(n_q)]).astype(np.float32)
    params['quantizer'] = dict(embed=embed, cluster_size=np.asarray(q.cluster_size),
                               embed_avg=embed, inited=np.ones_like(np.asarray(q.inited)))
    return params


# the JAX package's calls under jit: eager, each first call takes seconds
_jencode_stream = jax.jit(jstreaming.encode_stream, static_argnums=(0,),
                          static_argnames=('compute_dtype',))
_jdecode_stream = jax.jit(jstreaming.decode_stream, static_argnums=(0,),
                          static_argnames=('compute_dtype',))
_jencode = jax.jit(lambda model, params, x: model.encode(params, x)[0], static_argnums=(0,))


def _tiny_models(pad_mode='reflect', causal=True, norm='weight_norm'):
    """(JAX model, port model) of a tiny codec, causal by default."""
    seanet = dict(channels=1, dimension=16, n_filters=4, n_residual_layers=2, ratios=(4, 2),
                  causal=causal, pad_mode=pad_mode, lstm=1, norm=norm)
    jmodel = JaxEncodec(JaxEncoder(**seanet), JaxDecoder(**seanet),
                        JaxRVQ(dimension=16, n_q=3, bins=64), frame_rate=1000,
                        sample_rate=8000, channels=1, causal=causal)
    port = EncodecModel(SEANetEncoder(**seanet), SEANetDecoder(**seanet),
                        ResidualVectorQuantizer(dimension=16, n_q=3, bins=64), frame_rate=1000,
                        sample_rate=8000, channels=1, causal=causal)
    return jmodel, port.eval()


@functools.lru_cache(maxsize=None)
def _tiny(pad_mode='reflect'):
    """(JAX model, JAX params, port model) of the tiny causal codec, the
    JAX init carried across."""
    jmodel, port = _tiny_models(pad_mode)
    params = _random_codebooks(jmodel, jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0))), 1)
    port.load_state_dict(encodec_state_from_jax(port, params))
    return jmodel, jax.tree.map(jnp.asarray, params), port


def _wav(T, B=2, seed=0):
    return np.random.RandomState(seed).randn(B, 1, T).astype(np.float32) * 0.4


@pytest.mark.parametrize('pad_mode', ['reflect', 'constant'])
def test_encode_stream_codes_equal_jax_chunk_for_chunk(pad_mode):
    jmodel, params, port = _tiny(pad_mode)
    hop = port.encoder.hop_length   # 8
    wav = _wav(30 * hop)
    full = port.encode(torch.from_numpy(wav))[0].numpy()
    np.testing.assert_array_equal(full, np.asarray(_jencode(jmodel, params, jnp.asarray(wav))))
    assert len(np.unique(full)) > 20
    state = jstate = None
    chunks = []
    for start, size in ((0, 8), (8, 10), (18, 12)):   # in hops; the first covers the tail
        piece = wav[..., start * hop:(start + size) * hop]
        codes, state = streaming.encode_stream(port, torch.from_numpy(piece), state)
        ref, jstate = _jencode_stream(jmodel, params, jnp.asarray(piece), jstate)
        assert codes.shape == (2, 3, size)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
        chunks.append(codes.numpy())
    np.testing.assert_array_equal(np.concatenate(chunks, axis=-1), full)


def test_decode_stream_matches_jax_and_the_whole_decode():
    jmodel, params, port = _tiny()
    codes = port.encode(torch.from_numpy(_wav(24 * port.encoder.hop_length, seed=3)))[0]
    full = port.decode(codes).numpy()
    state = jstate = None
    outs = []
    for start, size in ((0, 8), (8, 6), (14, 10)):
        piece = codes[..., start:start + size]
        out, state = streaming.decode_stream(port, piece, state)
        ref, jstate = _jdecode_stream(jmodel, params, jnp.asarray(piece.numpy()), jstate)
        assert out.dtype == torch.float32 and out.shape == (2, 1, size * 8)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        outs.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=-1), full, rtol=1e-5, atol=1e-5)


def test_codec_streamer_buffering_matches_jax():
    """Ragged feeds of a hop-unaligned signal: the same chunks come out as
    from JAX's streamer, and ``flush`` pads the rest and counts what is real,
    both ways."""
    jmodel, params, port = _tiny()
    hop = port.encoder.hop_length
    wav = _wav(24 * hop + 3 * hop + 5, seed=5)
    ours = streaming.CodecStreamer(port, chunk=8 * hop)
    theirs = jstreaming.CodecStreamer(jmodel, params, chunk=8 * hop)
    got, ref = [], []
    for a, b in ((0, 7), (7, 57), (57, 58), (58, wav.shape[-1])):
        got.extend(o.numpy() for o in ours.feed(wav[..., a:b]))
        ref.extend(np.asarray(o) for o in theirs.feed(wav[..., a:b]))
    assert len(got) == len(ref) == 3
    np.testing.assert_array_equal(np.concatenate(got, -1), np.concatenate(ref, -1))
    tail, n_valid = ours.flush()
    jtail, j_valid = theirs.flush()
    assert n_valid == j_valid == 3 and tail.shape == (2, 3, 8)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(jtail))
    assert ours.flush() == (None, 0)
    whole = port.encode(torch.from_numpy(wav[..., :24 * hop]))[0].numpy()
    np.testing.assert_array_equal(np.concatenate(got, -1), whole)

    codes = np.concatenate(got + [tail.numpy()], -1)   # 32 frames, back to audio
    dec, jdec = (streaming.CodecStreamer(port, chunk=10, direction='decode'),
                 jstreaming.CodecStreamer(jmodel, params, chunk=10, direction='decode'))
    outs = [o.numpy() for o in dec.feed(codes[..., :13]) + dec.feed(codes[..., 13:])]
    jouts = [np.asarray(o) for o in jdec.feed(codes[..., :13]) + jdec.feed(codes[..., 13:])]
    (tail, n_valid), (jtail, j_valid) = dec.flush(), jdec.flush()
    assert len(outs) == len(jouts) == 3 and n_valid == j_valid == 2 * hop
    np.testing.assert_allclose(np.concatenate(outs + [tail.numpy()], -1),
                               np.concatenate(jouts + [np.asarray(jtail)], -1),
                               rtol=1e-5, atol=1e-5)


def test_streaming_refuses_what_jax_refuses():
    """Not causal, ``renormalize`` and ``time_group_norm``: the JAX package
    asserts, the port raises ValueError."""
    wav = _wav(64)
    _, params, _ = _tiny()   # the JAX checks come before any use of the params
    jmodel, port = _tiny_models(causal=False)
    with pytest.raises(AssertionError, match='causal'):
        jstreaming.encode_stream(jmodel, params, jnp.asarray(wav))
    with pytest.raises(ValueError, match='causal'):
        streaming.encode_stream(port, torch.from_numpy(wav))
    with pytest.raises(ValueError, match='causal'):
        streaming.CodecStreamer(port, chunk=64)

    jmodel, port = _tiny_models(norm='time_group_norm')
    with pytest.raises(AssertionError, match='time_group_norm'):
        jstreaming.encode_stream(jmodel, params, jnp.asarray(wav))
    with pytest.raises(ValueError, match='time_group_norm'):
        streaming.encode_stream(port, torch.from_numpy(wav))

    jmodel, params, port = _tiny()
    jnorm, norm = copy.copy(jmodel), copy.copy(port)
    object.__setattr__(jnorm, 'renormalize', True)   # past the constructor's own check
    norm.renormalize = True
    with pytest.raises(AssertionError, match='renormalize'):
        jstreaming.encode_stream(jnorm, params, jnp.asarray(wav))
    with pytest.raises(ValueError, match='renormalize'):
        streaming.encode_stream(norm, torch.from_numpy(wav))
    with pytest.raises(ValueError, match='hop'):
        streaming.encode_stream(port, torch.from_numpy(wav[..., :60]))
    # a first chunk of 6 frames meets the last conv's left pad of 6: its
    # reflection would read zeros where the whole signal reads samples; the
    # JAX package streams it and differs from its own whole encode
    with pytest.raises(ValueError, match='left pad'):
        streaming.encode_stream(port, torch.from_numpy(wav[..., :48]))
    streamed = np.asarray(_jencode_stream(jmodel, params, jnp.asarray(wav[..., :48]), None)[0])
    assert not np.array_equal(streamed, np.asarray(_jencode(jmodel, params, jnp.asarray(wav)))[
        ..., :6])


def test_published_24khz_topology_streams_like_jax():
    """The causal 24 kHz config (weight norm, a 2-layer LSTM) at a thin width:
    streamed codes equal JAX's and the whole encode; streamed audio within
    1e-5 of JAX's and 2e-5 of the whole decode."""
    jmodel = jax_encodec_24khz(n_filters=8)
    params = _random_codebooks(jmodel, jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(1))), 2)
    port = get_encodec_24khz(n_filters=8, device='cpu')
    port.load_state_dict(encodec_state_from_jax(port, params))
    params = jax.tree.map(jnp.asarray, params)
    hop = port.encoder.hop_length   # 320
    wav = _wav(10 * hop, B=1, seed=7)
    full = port.encode(torch.from_numpy(wav))[0]
    state = jstate = None
    parts = []
    for start, size in ((0, 7), (7, 3)):   # the first chunk past the last conv's pad of 6
        piece = wav[..., start * hop:(start + size) * hop]
        codes, state = streaming.encode_stream(port, torch.from_numpy(piece), state)
        ref, jstate = _jencode_stream(jmodel, params, jnp.asarray(piece), jstate,
                                      compute_dtype=jnp.float32)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
        parts.append(codes)
    assert torch.equal(torch.cat(parts, -1), full)
    whole = port.decode(full).numpy()
    state = jstate = None
    outs = []
    for start, size in ((0, 7), (7, 3)):
        out, state = streaming.decode_stream(port, full[..., start:start + size], state)
        ref, jstate = _jdecode_stream(jmodel, params, jnp.asarray(
            full[..., start:start + size].numpy()), jstate, compute_dtype=jnp.float32)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        outs.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(outs, -1), whole, rtol=2e-5, atol=2e-5)
