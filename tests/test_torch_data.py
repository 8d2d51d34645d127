"""The port's data modules (``data/``) and native audio codec bindings
(``io/native.py``) against the JAX package's, on the CPU.

Manifests written by one package are read by the other; at one seed and
epoch, ``AudioDataset`` draws JAX's files, seek times and samples: bit for
bit at 32 kHz, and at 44.1 kHz within the resampler tolerance that
``tests/test_torch_audio_io.py`` states (1e-5 relative, 1e-6 absolute; the
packages' resamplers sum in other orders).  The native decodes of FLAC, MP3
and Ogg files the tests write equal JAX's bit for bit; they skip only where
the library does not load.
"""

import gzip
import json
import zipfile

import numpy as np
import pytest
import torch

from audiocraft_tpu.data import audio_dataset as jax_ds
from audiocraft_tpu.data import info_audio_dataset as jax_info
from audiocraft_tpu.data import zip as jax_zip
from audiocraft_tpu.io import native as jax_native
from audiocraft_tpu.io import wav as jax_wav
from audiocraft_tpu.utils.misc import AudioCraftEnvironment as JaxEnvironment
from audiocraft_tpu_torch.data import audio_dataset as ds
from audiocraft_tpu_torch.data import info_audio_dataset as info
from audiocraft_tpu_torch.data import zip as pzip
from audiocraft_tpu_torch.io import native, wav
from audiocraft_tpu_torch.utils.misc import AudioCraftEnvironment

RESAMPLE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tone(seconds, sr, channels=1, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    freqs = 100 + 900 * rng.rand(channels, 1)
    return (0.3 * np.sin(2 * np.pi * freqs * t) + 0.02 * rng.randn(channels, t.size)
            ).astype(np.float32)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Five mono files at 32 kHz (1-2 s), a stereo one at 32 kHz, and two at
    44.1 kHz (one stereo), each in its own directory for the two rates."""
    root = tmp_path_factory.mktemp('corpus')
    (root / 'r32').mkdir()
    (root / 'r44').mkdir()
    for i in range(5):
        wav.wav_write(_tone(1.0 + 0.25 * i, 32000, seed=i), root / 'r32' / f'm{i}.wav', 32000)
    wav.wav_write(_tone(1.5, 32000, channels=2, seed=9), root / 'r32' / 'stereo.wav', 32000)
    wav.wav_write(_tone(1.2, 44100, seed=10), root / 'r44' / 'a.wav', 44100)
    wav.wav_write(_tone(1.7, 44100, channels=2, seed=11), root / 'r44' / 'b.wav', 44100)
    return root


def _metas(root):
    return ds.find_audio_files(root), jax_ds.find_audio_files(root)


def test_find_audio_files_matches_jax(corpus):
    ours, theirs = _metas(corpus)
    assert len(ours) == 8
    assert [m.to_dict() for m in ours] == [m.to_dict() for m in theirs]
    assert [m.to_dict() for m in ds.find_audio_files(corpus / 'r32', workers=2, minimal=False)] \
        == [m.to_dict() for m in jax_ds.find_audio_files(corpus / 'r32', minimal=False)]


@pytest.mark.parametrize('name', ['data.jsonl', 'data.jsonl.gz'])
@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_manifests_read_across_packages(corpus, tmp_path, name, writer):
    ours, _ = _metas(corpus)
    ours[0].weight = 2.5
    ours[1].info_path = pzip.PathInZip('/x/y.zip:a.json')
    path = tmp_path / name
    if writer == 'port':
        ds.save_audio_meta(path, ours)
        back = jax_ds.load_audio_meta(path)
    else:
        jax_ds.save_audio_meta(path, [jax_ds.AudioMeta.from_dict(m.to_dict()) for m in ours])
        back = ds.load_audio_meta(path)
    assert [m.to_dict() for m in back] == [m.to_dict() for m in ours]
    assert isinstance(back[1].info_path, (pzip.PathInZip, jax_zip.PathInZip))
    if name.endswith('.gz'):
        with gzip.open(path, 'rt') as f:
            assert json.loads(f.readline())['weight'] == 2.5
    # a directory holding the manifest
    ours_ds = ds.AudioDataset.from_meta(tmp_path, segment_duration=0.5, sample_rate=32000,
                                        channels=1)
    assert [m.path for m in ours_ds.meta] == [m.path for m in ours]


def _segments(make, meta, indices, epoch, **kw):
    dataset = make(meta, return_info=True, **kw)
    dataset.start_epoch(epoch)
    return [dataset[i] for i in indices]


@pytest.mark.parametrize('rate_dir,channels', [('r32', 1), ('r32', 2), ('r44', 1), ('r44', 2)])
def test_segments_match_jax(corpus, rate_dir, channels):
    meta, jmeta = _metas(corpus / rate_dir)
    kw = dict(segment_duration=0.5, num_samples=24, sample_rate=32000, channels=channels,
              shuffle_seed=3)
    for epoch in (0, 2):
        ours = _segments(ds.AudioDataset, meta, range(6), epoch, **kw)
        theirs = _segments(jax_ds.AudioDataset, jmeta, range(6), epoch, **kw)
        for (w, i), (jw, ji) in zip(ours, theirs):
            assert i.to_dict() == ji.to_dict()
            assert w.dtype == np.float32 and w.shape == (channels, 16000)
            if rate_dir == 'r32':
                np.testing.assert_array_equal(w, jw)
            else:
                np.testing.assert_allclose(w, jw, **RESAMPLE_TOL)
    # the same index at another epoch is another draw
    a = _segments(ds.AudioDataset, meta, [0], 0, **kw)[0][1]
    b = _segments(ds.AudioDataset, meta, [0], 1, **kw)[0][1]
    assert (a.meta.path, a.seek_time) != (b.meta.path, b.seek_time)


@pytest.mark.parametrize('mode', ['weight', 'duration', 'uniform', 'permutation', 'no_shuffle'])
def test_sampling_modes_match_jax(corpus, mode):
    meta, jmeta = _metas(corpus)
    for m, jm in zip(meta, jmeta):
        m.weight = jm.weight = 1.0 + len(m.path) % 3
    kw = dict(segment_duration=0.25, num_samples=40, sample_rate=32000, channels=1,
              load_wav=False)
    kw.update({'weight': dict(sample_on_duration=False),
               'duration': dict(sample_on_weight=False),
               'uniform': dict(sample_on_weight=False, sample_on_duration=False),
               'permutation': dict(sample_on_weight=False, sample_on_duration=False,
                                   permutation_on_files=True),
               'no_shuffle': dict(shuffle=False)}[mode])
    ours = _segments(ds.AudioDataset, meta, range(40), 1, **kw)
    theirs = _segments(jax_ds.AudioDataset, jmeta, range(40), 1, **kw)
    assert [i.to_dict() for _, i in ours] == [i.to_dict() for _, i in theirs]
    assert len({i.meta.path for _, i in ours}) > 1
    np.testing.assert_array_equal(
        ds.AudioDataset(meta, **kw).sampling_probabilities,
        jax_ds.AudioDataset(jmeta, **kw).sampling_probabilities)
    if mode == 'permutation':
        with pytest.raises(ValueError):
            ds.AudioDataset(meta, segment_duration=0.25, permutation_on_files=True)


def test_duration_filters_match_jax(corpus):
    meta, jmeta = _metas(corpus)
    for lo, hi in ((1.2, None), (None, 1.5), (1.1, 1.6)):
        kw = dict(segment_duration=0.2, min_audio_duration=lo, max_audio_duration=hi,
                  sample_rate=32000, channels=1)
        ours, theirs = ds.AudioDataset(meta, **kw), jax_ds.AudioDataset(jmeta, **kw)
        assert [m.path for m in ours.meta] == [m.path for m in theirs.meta]
        assert ours.total_duration == theirs.total_duration
        assert all((lo is None or m.duration >= lo) and (hi is None or m.duration <= hi)
                   for m in ours.meta)
    with pytest.raises(ValueError):
        ds.AudioDataset(meta, segment_duration=0.2, min_audio_duration=5.0)


def test_full_file_mode_and_collate_match_jax(corpus):
    meta, jmeta = _metas(corpus / 'r32')
    kw = dict(segment_duration=None, sample_rate=32000, channels=1, return_info=True)
    ours, theirs = ds.AudioDataset(meta, **kw), jax_ds.AudioDataset(jmeta, **kw)
    assert len(ours) == len(theirs) == 6
    items, jitems = [ours[i] for i in (1, 4, 5)], [theirs[i] for i in (1, 4, 5)]
    batch, infos = ours.collater(items)
    jbatch, jinfos = theirs.collater(jitems)
    np.testing.assert_array_equal(batch, jbatch)
    assert [i.to_dict() for i in infos] == [i.to_dict() for i in jinfos]
    assert infos[0].n_frames < infos[0].total_frames == batch.shape[-1]
    out, lengths = ds.collate([w for w, _ in items])
    jout, jlengths = jax_ds.collate([w for w, _ in jitems])
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(lengths, jlengths)


def test_shards_and_batches_match_jax(corpus, monkeypatch):
    meta, jmeta = _metas(corpus / 'r32')
    kw = dict(segment_duration=0.25, num_samples=10, sample_rate=32000, channels=1,
              shuffle=False)
    ours, theirs = ds.AudioDataset(meta, **kw), jax_ds.AudioDataset(jmeta, **kw)
    for count in (1, 2):
        for pi in range(count):
            assert list(ours.shard_indices(4, pi, count)) == \
                list(theirs.shard_indices(4, pi, count))
            got = list(ours.iter_batches(4, pi, count, epoch=0))
            want = list(theirs.iter_batches(4, pi, count, epoch=0))
            assert len(got) == len(want) >= 2
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        list(ours.shard_indices(3, 0, 2))
    # without arguments the rank and the count are the process group's
    import torch.distributed as dist
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_rank', lambda group=None: 1)
    monkeypatch.setattr(dist, 'get_world_size', lambda group=None: 2)
    for a, b in zip(ours.iter_batches(4), theirs.iter_batches(4, 1, 2)):
        np.testing.assert_array_equal(a, b)


def test_info_audio_dataset_matches_jax(corpus, tmp_path, monkeypatch):
    cfg = tmp_path / 'team.yaml'
    cfg.write_text('c:\n  dataset_mappers:\n    "^/moved": "%s"\n' % (corpus / 'r32'))
    monkeypatch.setenv('AUDIOCRAFT_CONFIG', str(cfg))
    monkeypatch.setenv('AUDIOCRAFT_CLUSTER', 'c')
    AudioCraftEnvironment.reset()
    JaxEnvironment.reset()
    try:
        def moved(meta_cls, zip_cls):
            return [meta_cls(f'/moved/m{i}.wav', 1.0 + 0.25 * i, 32000,
                             info_path=zip_cls(f'/moved/i{i}.zip:m.json')) for i in range(3)]

        kw = dict(segment_duration=0.5, num_samples=4, sample_rate=32000, channels=1,
                  return_info=True)
        ours = info.InfoAudioDataset(moved(ds.AudioMeta, pzip.PathInZip), **kw)
        theirs = jax_info.InfoAudioDataset(moved(jax_ds.AudioMeta, jax_zip.PathInZip), **kw)
        assert ours.meta[0].path == str(corpus / 'r32' / 'm0.wav')
        assert [m.to_dict() for m in ours.meta] == [m.to_dict() for m in theirs.meta]
        ours.start_epoch(0)
        theirs.start_epoch(0)
        w, seg = ours[2]
        jw, jseg = theirs[2]
        np.testing.assert_array_equal(w, jw)
        assert isinstance(seg, info.SegmentInfoWithAttributes)
        assert seg.to_dict() == jseg.to_dict()
        attrs, jattrs = seg.to_condition_attributes(), jseg.to_condition_attributes()
        assert (attrs.text, attrs.wav) == (jattrs.text, jattrs.wav) == ({}, {})
        ours.return_info = theirs.return_info = False
        np.testing.assert_array_equal(ours[2], theirs[2])
    finally:
        AudioCraftEnvironment.reset()
        JaxEnvironment.reset()


def test_path_in_zip_matches_jax(tmp_path):
    archive = tmp_path / 'a.zip'
    with zipfile.ZipFile(archive, 'w') as zf:
        zf.writestr('meta/x.json', b'{"k": 1}')
    p, jp = pzip.PathInZip(f'{archive}:meta/x.json'), jax_zip.PathInZip(f'{archive}:meta/x.json')
    assert (str(p), p.zip_path, p.file_path) == (str(jp), jp.zip_path, jp.file_path)
    assert hash(p) == hash(jp) == hash(str(p))
    assert p == pzip.PathInZip(str(p)) and p < pzip.PathInZip(f'{archive}:zz')
    with pzip.open_file_in_zip(p) as f, jax_zip.open_file_in_zip(jp) as g:
        assert f.read() == g.read() == b'{"k": 1}'
    with pytest.raises(ValueError):
        pzip.PathInZip('no-separator')


# ------------------------------------------------------------------ native

@pytest.fixture(scope='module')
def compressed(tmp_path_factory):
    if not native.available():
        pytest.skip(f'the native audio library does not load: {native.unavailable_reason()}')
    root = tmp_path_factory.mktemp('compressed')
    x = _tone(1.3, 44100, channels=2, seed=20)
    paths = {}
    for fmt in ('flac', 'mp3', 'ogg'):
        paths[fmt] = root / f'x.{fmt}'
        native.encode_audio(paths[fmt], x, 44100)
        jax_native.encode_audio(root / f'jax.{fmt}', x, 44100)
    return paths


def test_encoders_write_the_jax_bytes(compressed):
    for fmt, path in compressed.items():
        theirs = path.parent / f'jax.{fmt}'
        if fmt == 'ogg':   # an Ogg stream's serial number is drawn at random
            np.testing.assert_array_equal(native.decode_audio(path)[0],
                                          native.decode_audio(theirs)[0])
        else:
            assert path.read_bytes() == theirs.read_bytes(), fmt


@pytest.mark.parametrize('fmt', ['flac', 'mp3', 'ogg'])
def test_native_decodes_match_jax(compressed, fmt):
    path = compressed[fmt]
    assert native.probe_audio(path) == jax_native.probe_audio(path)
    assert wav.audio_info(path) == jax_wav.audio_info(path)
    full, sr = native.decode_audio(path)
    jfull, jsr = jax_native.decode_audio(path)
    assert sr == jsr == 44100 and full.shape[0] == 2 and full.dtype == np.float32
    np.testing.assert_array_equal(full, jfull)
    seg, _ = native.decode_audio(path, seek_time=0.4, duration=0.5)
    np.testing.assert_array_equal(seg, jax_native.decode_audio(path, 0.4, 0.5)[0])
    batch = native.decode_audio_batch([path, path], [0.0, 0.4], [-1.0, 0.5], num_threads=2)
    jbatch = jax_native.decode_audio_batch([path, path], [0.0, 0.4], [-1.0, 0.5], num_threads=2)
    for (a, asr), (b, bsr) in zip(batch, jbatch):
        assert asr == bsr
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(batch[0][0], full)
    got, _ = wav.audio_read(path, seek_time=0.4, duration=0.5, pad=True)
    np.testing.assert_array_equal(got, jax_wav.audio_read(path, 0.4, 0.5, pad=True)[0])
    with pytest.raises(RuntimeError, match='native batch decode failed'):
        native.decode_audio_batch([path, path.parent / 'missing.mp3'])


def test_compressed_audio_write_round_trips(compressed, tmp_path):
    x = _tone(1.0, 32000, channels=2, seed=21)
    for fmt in ('flac', 'mp3'):
        p = wav.audio_write(tmp_path / f'rt_{fmt}', x, 32000, format=fmt)
        jp = jax_wav.audio_write(tmp_path / f'jrt_{fmt}', x, 32000, format=fmt)
        assert p.suffix == f'.{fmt}'
        back, sr = wav.audio_read(p)
        np.testing.assert_array_equal(back, jax_wav.audio_read(jp)[0])
        n = min(back.shape[1], x.shape[1])
        assert sr == 32000 and n > 0.95 * 32000
    with pytest.raises(Exception):
        wav.audio_write(tmp_path / 'bad', x, 7000, format='mp3')   # lame refuses 7 kHz
    assert not (tmp_path / 'bad.mp3').exists()
    assert native.MIME_TYPES == jax_native.MIME_TYPES
    assert native.ENCODERS == jax_native.ENCODERS


def test_an_unloadable_library_says_why(tmp_path, monkeypatch):
    broken = tmp_path / 'libaudiocraft_audio.so'
    broken.write_bytes(b'not a shared object')
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_LIB_PATH', broken)
    assert not native.available()
    assert 'does not load' in native.unavailable_reason()
    with pytest.raises(native.NativeDecoderUnavailable, match='does not load'):
        wav.audio_read(tmp_path / 'x.mp3')
    with pytest.raises(native.NativeDecoderUnavailable, match='does not load'):
        wav.audio_write(tmp_path / 'y', np.zeros((1, 100), np.float32), 32000, format='flac')
    monkeypatch.setattr(native, '_LIB_PATH', tmp_path / 'absent.so')
    assert 'not built' in native.unavailable_reason()
