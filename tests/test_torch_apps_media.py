"""The media renderers, history, storage, the headless UI and the
generation CLIs against the JAX package's, on the CPU.

The renderers' outputs are equal to JAX's (waveform bars and their PNG, the
title card's and the video frame's pixels) or within 1e-5 (the log-mel
spectrogram); history, storage and the shortener write JAX's bytes from the
same inputs (the clock, the disk statistics and the short ids pinned in
both).  The apps load a checkpoint directory the JAX package writes of the
port's seeded debug facades (``torch_serving.write_debug_musicgen``) and
run greedy (top-k 1) in both packages: their 16-bit WAV files are within one
16-bit step of JAX's (two fp32 signals within 1e-5, the facade tests' bar,
may round to neighbouring codes).  ``scale_bench --cpu-virtual 2`` runs two
gloo ranks under a timeout of its own.
"""

import functools
import importlib.util
import json
import math
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from audiocraft_tpu.apps import batch_generate as jax_batch_generate
from audiocraft_tpu.apps import generate as jax_generate
from audiocraft_tpu.apps import history as jax_history
from audiocraft_tpu.apps import storage as jax_storage
from audiocraft_tpu.apps import ui as jax_ui
from audiocraft_tpu.ckpt import loaders as jax_loaders
from audiocraft_tpu.io import spectrogram as jax_spectrogram
from audiocraft_tpu.io import titlecard as jax_titlecard
from audiocraft_tpu.io import video as jax_video
from audiocraft_tpu.io import waveform as jax_waveform
from audiocraft_tpu_torch.apps import (batch_generate, generate, history, scale_bench, storage,
                                       ui)
from audiocraft_tpu_torch.ckpt import loaders
from audiocraft_tpu_torch.io import native, spectrogram, titlecard, video, waveform
from audiocraft_tpu_torch.io.wav import wav_read, wav_write

from torch_serving import tones, write_debug_musicgen

SR = 32000
STAMP = '20261018-120000'


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory):
    """(the debug facade's directory, the debug melody facade's, an empty
    cache directory); both packages' model caches cleared after."""
    root = tmp_path_factory.mktemp('apps_media')
    yield (write_debug_musicgen(root / 'debug', seed=11),
           write_debug_musicgen(root / 'melody', seed=12, melody=True),
           str(root / 'cache'))
    loaders.clear_model_cache()
    jax_loaders.clear_model_cache()


def within_one_step(ours: Path, theirs: Path) -> None:
    """Two 16-bit WAV files: the same header and samples within one code."""
    a, b = Path(ours).read_bytes(), Path(theirs).read_bytes()
    assert a[:44] == b[:44]
    diff = np.abs(np.frombuffer(a[44:], '<i2').astype(int) - np.frombuffer(b[44:], '<i2'))
    assert diff.max() <= 1


def greedy(model):
    """``model`` (a cached facade of either package) pinned to top-k 1."""
    model.set_generation_params = functools.partial(type(model).set_generation_params, model,
                                                    top_k=1)
    return model


# ---------------------------------------------------------------- renderers
def test_waveform_bars_and_image_match_jax(tmp_path):
    wav = tones(1.0, SR, seed=1)
    for bars in (40, 50, 7):
        np.testing.assert_array_equal(waveform.waveform_bars(wav, bars),
                                      jax_waveform.waveform_bars(wav, bars))
    assert waveform.waveform_bars(np.zeros(100, np.float32), 5).tolist() == [0.0] * 5
    ours = waveform.make_waveform_image(tmp_path / 'ours.png', wav)
    theirs = jax_waveform.make_waveform_image(tmp_path / 'theirs.png', wav)
    assert ours.stat().st_size > 1000 and ours.read_bytes() == theirs.read_bytes()


def test_title_card_and_video_frame_match_jax(tmp_path):
    for color in ('#ff0000', '#00ff0080', 'rgb(1, 2, 3)', 'rgba(1, 2, 3, 0.5)', (10, 20, 30),
                  (10, 20, 30, 0.5), 'navy', 'garbage!!'):
        assert titlecard.parse_color(color) == jax_titlecard.parse_color(color)
    kw = dict(title='A Long Generated Song Title That Wraps', description='model: small | '
              'seed: 42', width=320, height=200, font_color='#c87f05')
    img = titlecard.render_title_card(**kw)
    arr = np.asarray(img)
    assert img.size == (320, 200) and (arr != arr[0, 0]).any()
    np.testing.assert_array_equal(arr, np.asarray(jax_titlecard.render_title_card(**kw)))
    meta = {'prompt': 'p', 'Seed': 7, 'topk': 250, 'x': 'y', 'skip': [1]}
    assert titlecard.settings_text(meta) == jax_titlecard.settings_text(meta)

    from PIL import Image
    background = tmp_path / 'bg.png'
    Image.new('RGB', (64, 64), (10, 60, 90)).save(background)
    wav = tones(1.0, SR, seed=2)
    for frame_kw in (dict(), dict(title='My Song', settings='seed: 7', width=513),
                     dict(background=str(background), height=300)):
        frame = video.render_base_frame(wav, **frame_kw)
        assert frame.dtype == np.uint8 and frame.shape[2] == 3
        np.testing.assert_array_equal(frame, jax_video.render_base_frame(wav, **frame_kw))


def test_mel_spectrogram_matches_jax(tmp_path):
    """A tone over noise at 16 kHz, [T] and [C, T], numpy and a tensor."""
    rng = np.random.RandomState(3)
    t = np.arange(16000) / 16000
    wav = (np.sin(2 * np.pi * 1000 * t) + 0.1 * rng.randn(2, t.size)).astype(np.float32)
    for x in (wav[0], wav):
        ref = jax_spectrogram.mel_spectrogram(x, 16000)
        ours = spectrogram.mel_spectrogram(x, 16000)
        assert ours.shape == ref.shape and ours.shape[0] == 80 and ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(spectrogram.mel_spectrogram(torch.from_numpy(x), 16000),
                                      ours)
    assert 10 < ours.mean(axis=1).argmax() < 50     # the 1 kHz tone's mel band
    np.testing.assert_array_equal(spectrogram.mel_filterbank(32000, 512, 40),
                                  jax_spectrogram.mel_filterbank(32000, 512, 40))
    one = spectrogram.save_spectrogram(tmp_path / 'one.png', wav[0], 16000, title='test')
    two = spectrogram.save_spectrograms(tmp_path / 'two.png', [wav[0], wav], 16000, ['a', 'b'])
    assert one.stat().st_size > 1000 and two.stat().st_size > one.stat().st_size


def test_video_mux_and_metadata_round_trip(tmp_path):
    if not video.available():
        pytest.skip(f'native video muxer: {video.unavailable_reason()}')
    assert video.unavailable_reason() is None
    wav = tones(2.0, SR, seed=4)
    meta = {'title': 'My Song', 'artist': 'tester', 'comment': 'seed=7 | topk=50',
            'genre': 'electronic'}
    out = video.make_waveform_video(tmp_path / 'song.mp4', wav, SR, metadata=meta,
                                    title='My Song', settings='model: debug | seed: 7')
    assert out.stat().st_size > 10000
    tags = video.read_metadata(out)
    assert all(tags.get(k) == v for k, v in meta.items()), tags
    assert jax_video.read_metadata(out) == tags
    if native.available():
        info_sr, seconds, channels = native.probe_audio(out)
        assert info_sr == SR and channels == 1 and abs(seconds - 2.0) < 0.15
        decoded, rate = native.decode_audio(out)
        assert rate == SR and decoded.shape[-1] > SR
    stereo = video.make_waveform_video(tmp_path / 'stereo.mp4', np.concatenate([wav, -wav]), SR)
    assert stereo.stat().st_size > 10000


def test_video_refusal_names_the_loader(tmp_path, monkeypatch):
    """A library that does not load (a missing ffmpeg library, say) is
    NativeDecoderUnavailable with the loader's message, not an OSError."""
    broken = tmp_path / 'libaudiocraft_video.so'
    broken.write_text('not a shared object')
    monkeypatch.setattr(video, '_LIB_PATH', broken)
    monkeypatch.setattr(video, '_lib', None)
    assert not video.available() and 'does not load' in video.unavailable_reason()
    with pytest.raises(native.NativeDecoderUnavailable, match='does not load'):
        video.read_metadata(tmp_path / 'x.mp4')
    monkeypatch.setattr(video, '_LIB_PATH', tmp_path / 'missing.so')
    assert 'not built' in video.unavailable_reason()


# ---------------------------------------------------------- history, storage
@pytest.fixture
def pinned(monkeypatch):
    """The clock's stamp, the disk statistics and the short ids, fixed in
    both packages."""
    usage = shutil.disk_usage('/')._replace(total=100 * 2 ** 30, used=60 * 2 ** 30,
                                            free=4 * 2 ** 30)
    monkeypatch.setattr(shutil, 'disk_usage', lambda path: usage)
    monkeypatch.setattr(time, 'strftime', lambda fmt, *args: STAMP)
    for module in (storage, jax_storage):
        ids = iter(['abc', 'abc', 'def', 'ghi'] * 4)
        monkeypatch.setattr(module, '_short_id', lambda length=8, ids=ids: next(ids))


def _history_run(module, root: Path, src: Path, image: Path) -> dict:
    out = {}
    for user in ('alice', 'bob'):
        hist = module.GenerationHistory(root, user=user)
        out[f'{user} first'] = hist.save(src, label=f'{user} tune',
                                         metadata={'seed': 1, 'model': 'debug'})
        out[f'{user} second'] = hist.save(src, label='second', image_path=image)
    alice = module.GenerationHistory(root, user='alice')
    out['list'] = alice.list()
    out['gallery'] = module.render_gallery_html(alice, page=0, per_page=1)
    out['page'] = module.write_gallery(alice).read_text()
    out['stats'] = module.admin_stats(root)
    out['admin'] = module.render_admin_html(root)
    alice.delete(out['alice first']['audio'])
    out['jsonl'] = alice.jsonl.read_bytes()
    archive = alice.delete_all(archive_dir=root.parent / f'{root.name}-archives')
    out['archive'] = archive.name
    out['after'] = (alice.list(), module.admin_stats(root))
    return out


def test_history_admin_and_gallery_match_jax(tmp_path, pinned):
    src = tmp_path / 'src.wav'
    wav_write(tones(0.1, 16000, seed=5), src, 16000)
    image = tmp_path / 'cover.png'
    image.write_bytes(b'png!')
    ours = _history_run(history, tmp_path / 'ours', src, image)
    theirs = _history_run(jax_history, tmp_path / 'theirs', src, image)
    assert ours == theirs
    assert ours['stats']['users'] == 2 and ours['stats']['entries'] == 4
    assert ours['stats']['images'] == 2 and 'Low disk space' in ours['admin']
    assert ours['page'].count('<audio') == 2 and ours['after'][0] == []
    assert ours['alice second']['audio'] == f'{STAMP}-1.wav'


def test_storage_publish_and_shortener_match_jax(tmp_path, pinned):
    """Both packages publish the same files into the same root in turn: the
    copied files, the registry and the results are byte for byte JAX's."""
    wav, mp4, png = tmp_path / 'a.wav', tmp_path / 'a.mp4', tmp_path / 'a.png'
    wav.write_bytes(b'RIFF....WAVE')
    mp4.write_bytes(b'mp4!')
    png.write_bytes(b'png!')
    root = tmp_path / 'repo'
    runs = {}
    for name, module in (('jax', jax_storage), ('port', storage)):
        shutil.rmtree(root, ignore_errors=True)
        store = module.LocalStore(root, base_url='https://store.local/')
        first = module.publish(store, [wav, mp4, png], 'user/track/42')
        again = module.shorten_url(store, first['permalink'])
        other = module.publish(store, [mp4], 'user/video')
        runs[name] = (first, again, other, module.resolve_url(store, first['short_url']),
                      module.resolve_url(store, 'nope'),
                      {str(p.relative_to(root)): p.read_bytes()
                       for p in sorted(root.rglob('*')) if p.is_file()})
    assert runs['port'] == runs['jax']
    first, again, other, resolved, missing, files = runs['port']
    assert 'audio=' in first['permalink'] and 'video=' in first['permalink']
    assert again == first['short_url'] == 'abc' and resolved == first['permalink']
    assert missing is None and 'permalink' not in other
    assert len(json.loads(files['shortener.json'])) == 1
    assert storage.generate_permalink([]) is None


# -------------------------------------------------------------- the apps
def test_ui_predict_matches_jax(ckpts, tmp_path):
    debug, _, cache = ckpts
    kw = dict(duration=1.0, seed=7, top_k=1, cache_dir=cache)
    hist = history.GenerationHistory(tmp_path / 'h')
    path, seed = ui.predict(debug, 'test tune', device='cpu', history=hist, **kw)
    jpath, jseed = jax_ui.predict(debug, 'test tune', **kw)
    assert seed == jseed == 7 and path.suffix == '.wav'
    within_one_step(path, jpath)
    assert len(hist.list()) == 1 and hist.list()[0]['metadata']['seed'] == 7

    model = loaders.load_model(debug, cache, 'cpu')
    with pytest.raises(RuntimeError, match='melody'):
        ui.predict(model, 'x', melody=(SR, np.zeros(SR, np.float32)), duration=1.0, seed=1)
    if not video.available():
        return
    video_path, wav_path, seed = ui.predict(
        model, 'test tune', return_video=True, title='My Song', video_orientation='Portrait',
        settings_font_color='#ffcc00', settings_font_size=20, **kw)
    assert seed == 7 and video_path.suffix == '.mp4' and video_path.stat().st_size > 10000
    within_one_step(wav_path, jpath)
    tags = video.read_metadata(video_path)
    assert tags.get('title') == 'My Song'   # the container keeps its standard tags


def test_build_ui_refuses_without_gradio(monkeypatch):
    # a stand-in another test may have left under the name is not gradio
    monkeypatch.delitem(sys.modules, 'gradio', raising=False)
    if importlib.util.find_spec('gradio') is not None:
        pytest.skip('gradio is installed; the UI would build')
    with pytest.raises(RuntimeError, match='gradio is not installed'):
        ui.build_ui(model=None)


def test_generate_cli_matches_jax(ckpts, tmp_path, capsys):
    debug, _, cache = ckpts
    args = ['a calm piano piece', '--checkpoint', debug, '--top-k', '1', '--duration', '1',
            '--seed', '3']
    ours = generate.main([*args, '--out', str(tmp_path / 'ours.wav'), '--device', 'cpu'])
    jax_generate.main([*args, '--out', str(tmp_path / 'theirs.wav')])
    assert ours == tmp_path / 'ours.wav'
    within_one_step(ours, tmp_path / 'theirs.wav')
    out = capsys.readouterr().out
    assert 'wrote 1.0s of audio to' in out
    with pytest.raises(SystemExit, match="'self_wav'"):
        melody = tmp_path / 'melody.wav'
        wav_write(tones(1.0, SR, seed=6), melody, SR)
        generate.main([*args, '--melody', str(melody), '--device', 'cpu'])
    debug_out = generate.main(['beep', '--duration', '0.5', '--out', str(tmp_path / 'd.wav'),
                               '--device', 'cpu'])
    wav, rate = wav_read(debug_out)
    assert rate == SR and wav.shape == (1, 12 * 1280) and np.isfinite(wav).all()


def test_batch_generate_cli_matches_jax(ckpts, tmp_path):
    """Two plain prompts in one batch and a melody prompt in its own, on the
    debug melody facade; the port renders the videos in its spawn pool."""
    _, melody, cache = ckpts
    tune = tmp_path / 'tune.wav'
    wav_write(tones(2.0, SR, seed=7), tune, SR)
    prompts = tmp_path / 'prompts.txt'
    prompts.write_text(f'a calm piano piece\n# comment\n\nfollow this\t{tune}\nupbeat drums\n')
    assert batch_generate.read_prompts(prompts) == jax_batch_generate.read_prompts(prompts)
    greedy(loaders.load_model(melody, cache, 'cpu'))
    greedy(jax_loaders.load_model(melody, cache))
    args = [str(prompts), '--model', melody, '--cache-dir', cache, '--duration', '0.5',
            '--batch-size', '2']
    with_video = ['--video'] if video.available() else []
    manifest = batch_generate.main([*args, '--out', str(tmp_path / 'ours'), '--device', 'cpu',
                                    *with_video])
    jax_batch_generate.main([*args, '--out', str(tmp_path / 'theirs')])
    ours = json.loads((tmp_path / 'ours' / 'manifest.json').read_text())
    assert ours == manifest == json.loads((tmp_path / 'theirs' / 'manifest.json').read_text())
    assert [m['index'] for m in ours] == [0, 2, 1]     # the plain prompts first
    assert [m['prompt'] for m in ours] == ['a calm piano piece', 'upbeat drums', 'follow this']
    for m in ours:
        within_one_step(tmp_path / 'ours' / m['wav'], tmp_path / 'theirs' / m['wav'])
    if with_video:
        videos = sorted((tmp_path / 'ours').glob('*.mp4'))
        assert len(videos) == 3 and all(v.stat().st_size > 10000 for v in videos)
        assert video.read_metadata(videos[1])['major_brand'] == 'isom'


def test_scale_bench_on_two_gloo_ranks(monkeypatch, capsys):
    monkeypatch.setattr(scale_bench, 'RANK_TIMEOUT_S', 120)
    results = scale_bench.main(['--cpu-virtual', '2', '--batch-per-device', '2', '--seconds',
                                '1', '--iters', '2'])
    assert [r['devices'] for r in results] == [1, 2]
    assert results[0]['scaling_efficiency'] == 1.0
    for r in results:
        assert sorted(r) == ['audio_sec_per_s', 'devices', 'scaling_efficiency']
        assert math.isfinite(r['audio_sec_per_s']) and r['audio_sec_per_s'] > 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == results


@pytest.mark.parametrize('call', [
    lambda: generate.main(['x']),
    lambda: batch_generate.main(['prompts.txt', '--out', 'unused']),
    lambda: scale_bench.main(['--debug']),
    lambda: ui.predict('debug', 'x'),
], ids=['generate', 'batch_generate', 'scale_bench', 'ui.predict'])
def test_entry_points_refuse_without_the_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        call()
