"""The port's HTDemucs against the JAX package, on the CPU: the stems on
JAX's weights against ``tests/goldens/demucs_graph.npz``, the STFT pair and
the sin embeddings against JAX's, the state dict against the published
schema, the importer, segmented separation, the builder and the stem hook
feeding the chroma conditioner.

The config is tests/test_demucs.py's small one (channels 8, bottom 96, 2
cross-transformer layers, nfft 512, 16 kHz).  JAX's params are its
``init(PRNGKey(0))``, computed once under ``jax.jit`` (at XLA's backend
optimisation level 0, which compiles faster and draws the same numbers);
JAX's HTDemucs forward is never run, the golden stands for it.  Tolerances:
the golden's stems within JAX's own bar (atol 2e-5, rtol 1e-4); the STFT
pair within 1e-5 of its largest value; fp32 results that the port computes
in two ways within 1e-6 absolute.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiocraft_tpu.ckpt import demucs_import as jax_import
from audiocraft_tpu.nn import demucs as jax_demucs
from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.ckpt.demucs_import import htdemucs_state_schema, import_htdemucs
from audiocraft_tpu_torch.ckpt.from_jax import htdemucs_state_from_jax
from audiocraft_tpu_torch.cond.attributes import WavCondition
from audiocraft_tpu_torch.cond.chroma_cond import ChromaConditioner
from audiocraft_tpu_torch.nn import demucs
from audiocraft_tpu_torch.nn.demucs import HTDemucs, HTDemucsConfig, make_stem_fn

SMALL = dict(channels=8, bottom_channels=96, t_depth=2, nfft=512, sample_rate=16000)
CFG = HTDemucsConfig(**SMALL)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _wav(seed: int, samples: int, channels: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).randn(1, channels, samples).astype(np.float32) * 0.1


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """torch on one thread, as the other port test files run it: the CPU's
    convolutions at these sizes are slower on several threads, and the
    whole run's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jax_params():
    init = jax_demucs.HTDemucsConfig(**SMALL).model().init
    key = jax.random.PRNGKey(0)
    compiled = jax.jit(init).lower(key).compile({'xla_backend_optimization_level': 0})
    return jax.tree.map(np.asarray, compiled(key))


@pytest.fixture(scope='module')
def model(jax_params):
    m = HTDemucs(CFG).eval()
    m.load_state_dict(htdemucs_state_from_jax(m, jax_params), strict=True)
    return m


def test_stems_on_jax_params_match_the_golden(model):
    """The port's stems on JAX's ``init(PRNGKey(0))`` params equal
    ``demucs_graph.npz`` (JAX's stems) within atol 2e-5, rtol 1e-4."""
    stems = model.separate(torch.from_numpy(_wav(7, 8192))).numpy()
    ref = np.load(Path(__file__).parent / 'goldens' / 'demucs_graph.npz')['stems']
    assert stems.shape == ref.shape == (1, 4, 2, 8192)
    np.testing.assert_allclose(stems, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize('nfft,hop,samples', [(512, 128, 4096), (256, 64, 3001),
                                              (4096, 1024, 12288)])
def test_stft_pair_matches_jax(nfft, hop, samples):
    """``_stft`` and ``_istft`` against JAX's within 1e-5 of their largest
    values, the window, padding, scaling and Nyquist drop included."""
    x = np.random.RandomState(samples).randn(2, 2, samples).astype(np.float32)
    z = demucs._stft(torch.from_numpy(x), nfft, hop)
    ref = jax.jit(jax_demucs._stft, static_argnums=(1, 2))(jnp.asarray(x), nfft, hop)
    assert z.shape == ref.shape and z.dtype == torch.complex64
    assert _rel(z.numpy(), np.asarray(ref)) < 1e-5
    back = demucs._istft(z, nfft, hop, samples)
    ref_back = jax.jit(jax_demucs._istft, static_argnums=(1, 2, 3))(ref, nfft, hop, samples)
    assert _rel(back, ref_back) < 1e-5
    # a network's spectrum has an imaginary DC part, which the inverse drops
    dc = torch.zeros_like(z.real)
    dc[:, :, 0] = torch.randn(z.shape[:2] + z.shape[3:])
    z = z + 1j * dc
    ref = np.asarray(ref) + 1j * dc.numpy()
    back = demucs._istft(z, nfft, hop, samples)
    ref_back = jax.jit(jax_demucs._istft, static_argnums=(1, 2, 3))(ref, nfft, hop, samples)
    assert _rel(back, ref_back) < 1e-5


@pytest.mark.parametrize('length,dim', [(37, 96), (20, 10)])
def test_sin_embedding_matches_jax(length, dim):
    ours = demucs._sin_embed(length, dim, 'cpu')
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_demucs._sin_embed(length, dim)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('dim,height,width', [(96, 8, 5), (12, 3, 7)])
def test_2d_sin_embedding_matches_jax(dim, height, width):
    ours = demucs._sin_embed_2d(dim, height, width, 'cpu')
    ref = jax_demucs._sin_embed_2d(dim, height, width)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('cfg', [CFG, HTDemucsConfig()], ids=['small', 'published'])
def test_state_dict_keys_are_the_published_schema(cfg):
    """The port's names are the demucs package's: the state dict's keys equal
    the schema, the JAX package's schema too."""
    keys = set(HTDemucs(cfg).state_dict())
    assert keys == htdemucs_state_schema(cfg)
    assert keys == jax_import.htdemucs_state_schema(jax_demucs.HTDemucsConfig(
        **{f: getattr(cfg, f) for f in ('channels', 'bottom_channels', 't_depth', 'nfft',
                                        'sample_rate')}))


def test_from_jax_is_the_jax_importers_inverse(model, jax_params):
    """The port's state dict, read by JAX's importer, gives JAX's params
    back with nothing unmapped."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, unmapped = jax_import.import_htdemucs(
        jax_demucs.HTDemucsConfig(**SMALL).model(), sd)
    assert unmapped == []
    flat = dict(jax.tree_util.tree_flatten_with_path(jax_params)[0])
    back = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert flat.keys() == back.keys()
    for path, value in flat.items():
        np.testing.assert_array_equal(np.asarray(back[path]), value, err_msg=str(path))


def test_import_of_a_schema_state_dict_is_clean(model):
    """A state dict of exactly the schema's keys imports with nothing
    unmapped and gives the exporting model's stems; an extra key comes
    back unmapped, a missing one raises.  Every import warns that the
    decoders run the taps mirrored."""
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    assert set(sd) == htdemucs_state_schema(CFG)
    fresh = HTDemucs(CFG, torch.Generator().manual_seed(5)).eval()
    with pytest.warns(UserWarning, match='mirrored'):
        assert import_htdemucs(fresh, sd) == []
    wav = torch.from_numpy(_wav(3, 8192))
    np.testing.assert_allclose(fresh.separate(wav).numpy(), model.separate(wav).numpy(),
                               atol=1e-6)
    with pytest.warns(UserWarning, match='mirrored'):
        assert import_htdemucs(fresh, {**sd, 'decoder.0.dconv.layers.0.0.weight': sd[
            'encoder.0.dconv.layers.0.0.weight']}) == ['decoder.0.dconv.layers.0.0.weight']
    del sd['freq_emb.embedding.weight']
    with pytest.raises(KeyError):
        import_htdemucs(fresh, sd)


def test_one_window_segmented_equals_the_single_pass(model):
    wav = torch.from_numpy(_wav(7, 8192))
    one = model.separate(wav)
    seg = model.separate(wav, segment=8192 / 16000)
    np.testing.assert_allclose(seg.numpy(), one.numpy(), atol=1e-6)


def test_segmented_separation_is_the_triangular_blend(model):
    """On 40960 samples with 0.6 s windows (10240 samples, stride 7680, six
    windows): the windows' stems weighted by the triangle and normalised by
    the weights' sum, as JAX's ``separate`` blends them."""
    wav = torch.from_numpy(_wav(8, 40960))
    out = model.separate(wav, segment=0.6)
    seg = model.segment_length(0.6)
    stride = int(seg * 0.75)
    assert (seg, stride) == (10240, 7680)
    w = torch.from_numpy(np.minimum(np.arange(1, seg + 1), np.arange(seg, 0, -1))
                         .astype(np.float32))
    w = w / w.max()
    padded = torch.nn.functional.pad(wav, (0, seg))
    total = torch.zeros(1, 4, 2, 40960 + seg)
    weight = torch.zeros(40960 + seg)
    starts = list(range(0, 40960, stride))
    assert len(starts) == 6
    for s in starts:
        total[..., s:s + seg] += model(padded[..., s:s + seg]) * w
        weight[s:s + seg] += w
    np.testing.assert_allclose(out.numpy(), (total / weight)[..., :40960].numpy(), atol=1e-6)
    assert torch.isfinite(out).all()


def test_mono_input_is_duplicated_to_stereo(model):
    mono = torch.from_numpy(_wav(2, 4096, channels=1))
    np.testing.assert_allclose(model.separate(mono).numpy(),
                               model.separate(mono.repeat(1, 2, 1)).numpy(), atol=1e-7)


def test_forward_restores_the_cudnn_tf32_flag(model):
    before = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        model.separate(torch.from_numpy(_wav(2, 4096)))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_stem_fn_feeds_the_chroma_conditioner(model):
    """``make_stem_fn``: 32 kHz mono in, separated at 16 kHz stereo, the
    vocals and other stems summed, 32 kHz mono numpy out; equal to doing
    those steps by hand; ``ChromaConditioner.tokenize`` takes it."""
    from audiocraft_tpu_torch.io.audio_utils import convert_audio
    stem_fn = make_stem_fn(model, cond_sample_rate=32000, stems=('vocals', 'other'))
    wav = np.random.RandomState(5).randn(1, 1, 32000).astype(np.float32) * 0.1
    out = stem_fn(wav)
    x = convert_audio(torch.from_numpy(wav), 32000, 16000, 2)
    stems = model.separate(x)
    ref = convert_audio(stems[:, 3] + stems[:, 2], 16000, 32000, 1)
    assert isinstance(out, np.ndarray) and out.shape == (1, 1, 32000)
    np.testing.assert_allclose(out, ref.numpy(), atol=1e-6)
    cond = ChromaConditioner(output_dim=16, sample_rate=32000, duration=1.0)
    wc = WavCondition(wav, np.array([32000]), [32000], [None], [0.0])
    filtered = cond.tokenize(wc, stem_fn=stem_fn)
    np.testing.assert_array_equal(filtered.wav, out)
    embeds, _ = cond(filtered)
    assert torch.isfinite(embeds).all()


def test_get_htdemucs_builds_the_published_config():
    m = builders.get_htdemucs(device='cpu')
    assert m.cfg == HTDemucsConfig() and not m.training
    assert m.segment_length() == 344064 and m.has_resample
    assert not any(p.requires_grad for p in m.parameters())
    again = builders.get_htdemucs(device='cpu')
    assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                 again.state_dict().values()))
