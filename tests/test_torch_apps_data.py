"""The data-to-tokens apps against the JAX package's, on the CPU: the
``tokenize`` CLI (batched, ``--chunk`` and ``--pod``), ``eval_codec``, and
the training CLIs reading a DATA_DIR.

Both packages load one codec checkpoint directory that the JAX package
writes: the port's seeded debug codec with its codebooks seeded from
audio latents (``chip_smoke.seed_codebooks``), so that codes spread over
the codebooks, carried into JAX's params by JAX's importer.  In fp32 the
tokenize CLIs' npz codes are equal; ``eval_codec``'s SI-SNR, mel distance
and L1 agree within 1e-4 relative and its entropy, usage and bitrate are
equal.  The pod files are a multiple of 8 hops long after resampling: pod
encodes the signal zero-padded to a multiple of hop x shards, and JAX's pod
here has the 8 CPU devices' shards where the port's single process has one.
"""

import json
import math
import re

import numpy as np
import pytest
import torch

import jax

from audiocraft_tpu import builders as jax_builders
from audiocraft_tpu.apps import eval_codec as jax_eval_codec
from audiocraft_tpu.apps import tokenize as jax_tokenize
from audiocraft_tpu.ckpt import io as jax_io
from audiocraft_tpu.ckpt import torch_import as jax_import
from audiocraft_tpu.data.audio_dataset import AudioDataset as JaxAudioDataset
from audiocraft_tpu_torch import builders
from audiocraft_tpu_torch.apps import eval_codec, tokenize, train_encodec, train_lm
from audiocraft_tpu_torch.data.audio_dataset import AudioDataset
from audiocraft_tpu_torch.io import native, wav

SR = 32000
HOP = 1280               # the debug codec's hop at 32 kHz


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tones(seconds, sr, channels, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    freqs = 80 + 1500 * rng.rand(channels, 3, 1)
    x = 0.15 * np.sin(2 * np.pi * freqs * t).sum(1) + 0.03 * rng.randn(channels, t.size)
    return x.astype(np.float32)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """The corpus (32 kHz mono 3.2 s, 44.1 kHz stereo 3.2 s, 32 kHz mono
    2.5 s) and the codec directory the JAX package writes."""
    import chip_smoke

    root = tmp_path_factory.mktemp('apps_data')
    data = root / 'data'
    data.mkdir()
    wav.wav_write(_tones(3.2, SR, 1, 0), data / 'a.wav', SR)
    wav.wav_write(_tones(3.2, 44100, 2, 1), data / 'b.wav', 44100)
    wav.wav_write(_tones(2.5, SR, 1, 2), data / 'c.wav', SR)
    codec = builders.get_debug_compression_model(32000, device='cpu', seed=3)
    chip_smoke.seed_codebooks(codec, chip_smoke._clips(2, 10 * SR, 'cpu', seed=5))
    jcodec = jax_builders.get_debug_compression_model(32000)
    params = jax_import.import_encodec(
        jcodec, {k: v.numpy() for k, v in codec.state_dict().items()})
    jax_io.save_checkpoint(root / 'codec', jcodec, params)
    return root, data, [str(data / n) for n in ('a.wav', 'b.wav', 'c.wav')]


def _run_tokenize(root, inputs, extra, capsys):
    """(port's npz, JAX's npz, port's stderr, JAX's stderr)."""
    out = {}
    for name, main, device in (('port', tokenize.main, ['--device', 'cpu']),
                               ('jax', jax_tokenize.main, [])):
        path = root / f'{name}_{extra[0].strip("-")}.npz'
        main([*inputs, '--out', str(path), '--checkpoint', str(root / 'codec'), '--stats',
              *extra, *device])
        with np.load(path) as z:
            out[name] = {k: z[k] for k in z.files}
        out[name + '_err'] = capsys.readouterr().err
    return out['port'], out['jax'], out['port_err'], out['jax_err']


def test_tokenize_batched_matches_jax(setup, capsys):
    root, data, inputs = setup
    if native.available():   # the native batch decoder then reads every row
        native.encode_audio(root / 'd.flac', _tones(2.2, 44100, 1, 3), 44100)
        inputs = [*inputs, str(root / 'd.flac')]
    ours, theirs, err, jerr = _run_tokenize(
        root, inputs, ['--batch-seconds', '1.0', '--batch-rows', '4'], capsys)
    assert ours['codes'].dtype == theirs['codes'].dtype == np.int32
    assert ours['codes'].shape == theirs['codes'].shape
    assert ours['codes'].shape[:2] == (4 + 4 + 3 + 3 * native.available(), 4)
    np.testing.assert_array_equal(ours['codes'], theirs['codes'])
    assert ours['meta'].tobytes() == theirs['meta'].tobytes()
    spread = [len(np.unique(ours['codes'][:, k])) for k in range(4)]
    assert spread[0] > 20 and min(spread) > 1, f'trivial codes: {spread} distinct'
    line = re.compile(r'tokenize pipeline: (\d+) items \| ([\d.]+) audio-sec \([\d.]+/s\) \| '
                      r'(\d+) tokens')
    assert line.search(err).groups() == line.search(jerr).groups()
    assert 'tokenize host: ' in err and 'waited' in err


@pytest.mark.parametrize('mode', [['--chunk', '--chunk-frames', '24'], ['--pod']])
def test_tokenize_whole_files_match_jax(setup, capsys, mode):
    root, data, inputs = setup
    inputs = inputs[:2]     # 102400 samples at 32 kHz each: 80 hops, a multiple of 8
    ours, theirs, err, jerr = _run_tokenize(root, inputs, mode, capsys)
    assert sorted(ours) == sorted(theirs) == ['codes_0', 'codes_1', 'meta']
    for key in ('codes_0', 'codes_1'):
        assert ours[key].shape == (4, 102400 // HOP)
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours['meta'].tobytes() == theirs['meta'].tobytes()
    label = {'--chunk': 'chunked', '--pod': 'pod'}[mode[0]]
    line = re.compile(label + r' tokenize: (\d+) file\(s\), ([\d.]+) audio-sec')
    assert line.search(err).groups() == line.search(jerr).groups() == ('2', '6.4')
    if mode[0] == '--pod':
        assert 'over 1 device(s)' in err and f'over {len(jax.devices())} device(s)' in jerr


def _compare_metrics(ours, theirs):
    for key in ('sisnr_db', 'msspec_distance', 'l1'):
        assert math.isfinite(ours[key])
        assert ours[key] == pytest.approx(theirs[key], rel=1e-4), key
    for key in ('codebook_entropy_bits', 'codebook_usage', 'bitrate_kbps', 'n_segments',
                'segment_seconds'):
        assert ours[key] == theirs[key], key
    assert max(ours['codebook_usage']) > 0.01, 'trivial codes'


@pytest.mark.parametrize('source', ['synthetic', 'directory'])
def test_eval_codec_matches_jax(setup, capsys, source):
    root, data, _ = setup
    args = ['--batches', '2', '--batch', '2', '--segment', '0.5', '--ckpt', str(root / 'codec')]
    args = ['--synthetic', *args] if source == 'synthetic' else [str(data), *args]
    ours = eval_codec.main([*args, '--device', 'cpu', '--json', str(root / f'{source}.json')])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    theirs = jax_eval_codec.main(args)
    assert printed == ours == json.loads((root / f'{source}.json').read_text())
    _compare_metrics(ours, theirs)
    from audiocraft_tpu_torch.ckpt.io import load_checkpoint
    model = load_checkpoint(root / 'codec', 'cpu')[0]
    assert ours['bitrate_kbps'] == model.frame_rate * 4 * math.log2(400) / 1000.0
    assert ours['n_segments'] == 4


def test_eval_codec_fad_runs(setup):
    root, data, _ = setup
    m = eval_codec.main([str(data), '--batches', '2', '--batch', '2', '--segment', '1.0',
                         '--ckpt', str(root / 'codec'), '--fad', '--device', 'cpu'])
    for key in ('fad_codec', 'kld_codec', 'kld_codec_symmetric'):
        assert math.isfinite(m[key]) and m[key] >= 0, key


def _first_batches(monkeypatch):
    seen = []
    collater = AudioDataset.collater

    def recording(self, samples):
        out = collater(self, samples)
        seen.append(out)
        return out

    monkeypatch.setattr(AudioDataset, 'collater', recording)
    return seen


def _jax_first_batch(data, segment, batch, steps):
    ds = JaxAudioDataset.from_path(data, segment_duration=segment, sample_rate=SR, channels=1,
                                   num_samples=steps * batch)
    ds.start_epoch(0)
    return next(ds.iter_batches(batch, 0, 1))


@pytest.mark.parametrize('cli', ['train_encodec', 'train_lm'])
def test_train_clis_read_a_data_dir(setup, capsys, monkeypatch, cli):
    root, data, _ = setup
    seen = _first_batches(monkeypatch)
    main = {'train_encodec': train_encodec.main, 'train_lm': train_lm.main}[cli]
    main([str(data), '--debug', '--steps', '1', '--batch', '2', '--segment', '0.5',
          '--device', 'cpu'])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith('step')]
    assert len(lines) == 1
    losses = [float(v) for v in re.findall(r'(?:loss|ce) ([-\d.naif]+)', lines[0])]
    assert losses and all(math.isfinite(v) for v in losses)
    assert len(seen) == 1 and seen[0].shape == (2, 1, SR // 2)
    # the 44.1 kHz file's rows within the resampler tolerance of
    # tests/test_torch_audio_io.py (tests/test_torch_data.py holds 32 kHz
    # rows bit for bit)
    np.testing.assert_allclose(seen[0], _jax_first_batch(data, 0.5, 2, 1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('entry', ['tokenize', 'eval_codec', 'train_encodec', 'train_lm'])
def test_data_clis_refuse_to_fall_back_to_the_cpu(setup, monkeypatch, entry):
    root, data, inputs = setup
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    calls = {
        'tokenize': lambda: tokenize.main([inputs[0], '--out', str(root / 'x.npz')]),
        'eval_codec': lambda: eval_codec.main([str(data), '--batches', '1']),
        'train_encodec': lambda: train_encodec.main([str(data), '--debug', '--steps', '1']),
        'train_lm': lambda: train_lm.main([str(data), '--debug', '--steps', '1']),
    }
    with pytest.raises(RuntimeError, match='CUDA'):
        calls[entry]()
    assert not (root / 'x.npz').exists()
