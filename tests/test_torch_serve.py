"""The REST server (``apps/serve.py``) against the JAX package's, on the CPU.

Both services serve checkpoint directories the JAX package writes of the
port's seeded debug facades (``torch_serving.write_debug_musicgen``), by
the same name.  ``topk: 1`` requests are greedy in both packages: their
tokens are equal and the port's fp32 audio is within rtol 1e-5 / atol 1e-5
of JAX's (the facade tests' bar, ``test_torch_generate.py``), for text, a
continuation, a melody, int8 and int4 weights and int8 KV caches.  Over HTTP
a 16-bit WAV carries the float result: the port's body is
``_wav_bytes`` of its service's result, byte for byte, and its samples are
within one 16-bit step of JAX's body.  Every server is shut down, every
thread joined under a timeout and every ``urlopen`` has one.
"""

import base64
import contextlib
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax

from audiocraft_tpu.apps import serve as jax_serve
from audiocraft_tpu.ckpt import loaders as jax_loaders
from audiocraft_tpu_torch.apps import serve
from audiocraft_tpu_torch.ckpt import loaders
from audiocraft_tpu_torch.io import native, video
from audiocraft_tpu_torch.nn.transformer import QuantizedWeight

from torch_serving import tones, write_debug_musicgen

SR = 32000
HOP = 1280      # the debug codec's: 25 frames a second
TIMEOUT = 120   # seconds for any one request or join


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def clear_caches():
    yield
    loaders.clear_model_cache()
    jax_loaders.clear_model_cache()


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory):
    """(the debug facade's directory, the debug melody facade's, an empty
    cache directory)."""
    root = tmp_path_factory.mktemp('serve')
    return (write_debug_musicgen(root / 'debug', seed=7),
            write_debug_musicgen(root / 'melody', seed=8, melody=True),
            str(root / 'cache'))


@contextlib.contextmanager
def http(service):
    """``service`` behind a ThreadingHTTPServer on 127.0.0.1:0 -> its URL;
    the server shut down, its thread joined and the service closed after."""
    module = serve if isinstance(service, serve.GenerationService) else jax_serve
    server = ThreadingHTTPServer(('127.0.0.1', 0), module.make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f'http://127.0.0.1:{server.server_address[1]}'
    finally:
        server.shutdown()
        server.server_close()
        thread.join(TIMEOUT)
        assert not thread.is_alive()
        if isinstance(service, serve.GenerationService):
            service.close()


def get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def post(url, body):
    """-> (status, headers, body bytes); an HTTP error's code and body too."""
    req = urllib.request.Request(f'{url}/generate', data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, exc.headers, exc.read()


def pcm(body: bytes) -> np.ndarray:
    """A 16-bit WAV body's samples as int16 codes [C, T]."""
    channels = int.from_bytes(body[22:24], 'little')
    return np.frombuffer(body[44:], '<i2').reshape(-1, channels).T


def wav_b64(wav: np.ndarray) -> str:
    return base64.b64encode(serve._wav_bytes(wav, SR)).decode()


def port_service(**kw):
    return serve.GenerationService(device='cpu', **kw)


def direct_tokens(port_model, jax_model, texts, **params):
    """The cached facades' greedy tokens for ``texts`` (the settings a
    served request sets), port and JAX."""
    for mg in (port_model, jax_model):
        mg.set_generation_params(**params)
    ours = port_model.generate(texts, return_tokens=True)[1]
    theirs = jax_model.generate(texts, key=jax.random.PRNGKey(0), return_tokens=True)[1]
    return ours.numpy(), np.asarray(theirs)


def assert_close(ours, theirs):
    assert ours['wav'].shape == theirs['wav'].shape
    np.testing.assert_allclose(ours['wav'], theirs['wav'], rtol=1e-5, atol=1e-5)
    assert ours['metadata'] == theirs['metadata'] and ours['seed'] == theirs['seed']


def test_http_text_request_matches_jax(ckpts):
    debug, _, cache = ckpts
    req = {'text': 'a calm piano piece', 'duration': 1.0, 'seed': 7, 'topk': 1,
           'model': debug}
    port, theirs = port_service(default_model=debug, cache_dir=cache), \
        jax_serve.GenerationService(debug, cache_dir=cache)
    ours_direct, theirs_direct = port.generate(req), theirs.generate(req)
    assert ours_direct['wav'].shape == (1, SR) and ours_direct['wav'].dtype == np.float32
    assert_close(ours_direct, theirs_direct)
    tokens, jtokens = direct_tokens(loaders.load_model(debug, cache, 'cpu'),
                                    jax_loaders.load_model(debug, cache), [req['text']],
                                    duration=1.0, top_k=1)
    np.testing.assert_array_equal(tokens, jtokens)

    bodies = {}
    for name, service in (('port', port), ('jax', theirs)):
        with http(service) as url:
            assert get(f'{url}/health') == {'status': 'ok', 'model': debug}
            assert get(f'{url}/models') == {'models': ['debug'], 'current': debug}
            status, headers, bodies[name] = post(url, req)
            assert status == 200 and headers['Content-Type'] == 'audio/wav'
            assert headers['X-Seed'] == '7'
    assert bodies['port'] == serve._wav_bytes(ours_direct['wav'], SR)
    assert bodies['port'][:44] == bodies['jax'][:44]
    ours, theirs = pcm(bodies['port']).astype(int), pcm(bodies['jax']).astype(int)
    assert np.abs(ours - theirs).max() <= 1


def test_continuation_and_history_json_match_jax(ckpts):
    debug, _, cache = ckpts
    req = {'text': 'continue it', 'duration': 2.0, 'seed': 8, 'topk': 1, 'model': debug,
           'prompt_wav': wav_b64(tones(0.5, SR, seed=3)), 'return_history_json': True}
    port = port_service(default_model=debug, cache_dir=cache)
    ours = port.generate(req)
    assert ours['wav'].shape == (1, 2 * SR)
    assert ours['metadata']['continuation'] is True
    assert_close(ours, jax_serve.GenerationService(debug, cache_dir=cache).generate(req))
    with http(port) as url:
        status, headers, body = post(url, req)
    assert status == 200 and headers['Content-Type'] == 'application/json'
    doc = json.loads(body)
    assert doc['seed'] == 8 and doc['metadata'] == ours['metadata']
    assert base64.b64decode(doc['audio_b64']) == serve._wav_bytes(ours['wav'], SR)


def test_melody_request_matches_jax(ckpts):
    _, melody, cache = ckpts
    req = {'text': 'follow this melody', 'duration': 1.0, 'seed': 9, 'topk': 1,
           'model': melody, 'melody_wav': wav_b64(tones(2.0, SR, seed=4))}
    ours = port_service(default_model=melody, cache_dir=cache).generate(req)
    assert ours['metadata']['melody_condition'] is True
    assert_close(ours, jax_serve.GenerationService(melody, cache_dir=cache).generate(req))


def test_response_formats_and_refusals(ckpts):
    debug, _, cache = ckpts
    base = {'text': 'beep', 'duration': 0.5, 'seed': 7, 'model': debug}
    with http(port_service(default_model=debug, cache_dir=cache)) as url:
        if native.available():
            status, headers, body = post(url, {**base, 'return_format': 'mp3'})
            assert status == 200 and headers['Content-Type'] == 'audio/mpeg'
            assert len(body) > 0 and body[:4] != b'RIFF'
            assert post(url, {**base, 'return_format': 'xm'})[0] == 400
        if video.available():
            status, headers, body = post(url, {**base, 'return_video': True,
                                               'title': 'My Song'})
            assert status == 200 and headers['Content-Type'] == 'video/mp4'
            assert headers['X-Seed'] == '7' and len(body) > 1000
        for bad in ({'duration': 1.0}, {'text': 'x', 'duration': -3},
                    {'text': 'x', 'duration': 721}):
            status, _, body = post(url, bad)
            assert status == 400 and 'error' in json.loads(body)
        status, _, body = post(url, {'text': 'x', 'model': 'melody-large'})
        assert status == 404 and 'no imported checkpoint' in json.loads(body)['error']


def _quantized(model) -> bool:
    return any(isinstance(m, QuantizedWeight) for m in model.lm.modules())


def test_quantized_services_match_jax(ckpts):
    """A plain service serves the model first; an int4 service then
    quantizes the same cached model (its decode states and CUDA graphs are
    keyed by signature, so nothing is dropped by hand) and serves JAX's int4
    result, not the plain one.  Then int8 weights, and int8 weights with
    int8 KV caches, on fresh loads."""
    debug, _, cache = ckpts
    req = {'text': 'quantized tune', 'duration': 0.5, 'seed': 4, 'topk': 1, 'model': debug}
    plain = port_service(default_model=debug, cache_dir=cache).generate(req)
    jplain = jax_serve.GenerationService(debug, cache_dir=cache).generate(req)
    assert_close(plain, jplain)
    model = loaders.load_model(debug, cache, 'cpu')
    assert not _quantized(model) and len(model._decode_cache) == 1

    for i, kw in enumerate((dict(quantize='int4'), dict(quantize=True),
                            dict(quantize='int8', kv_dtype='int8'))):
        if i:
            loaders.clear_model_cache()
            jax_loaders.clear_model_cache()
        ours = port_service(default_model=debug, cache_dir=cache, **kw).generate(req)
        assert_close(ours, jax_serve.GenerationService(debug, cache_dir=cache,
                                                       **kw).generate(req))
        served = loaders.load_model(debug, cache, 'cpu')
        assert _quantized(served) and served.kv_dtype == kw.get('kv_dtype')
        assert served.kv_buckets == ('auto' if 'kv_dtype' in kw else None)
        if i == 0:
            assert served is model and len(model._decode_cache) == 2
            assert not np.array_equal(ours['wav'], plain['wav'])


def test_continuous_batching(ckpts, monkeypatch):
    """Three concurrent compatible requests make one facade call padded to
    the bucket of 4 by repeating the first prompt; two durations make two
    calls; a bad request raises on the caller's thread."""
    debug, _, cache = ckpts
    service = port_service(default_model=debug, cache_dir=cache, batch_window_ms=2000,
                           max_batch=3)
    model = loaders.load_model(debug, cache, 'cpu')
    calls = []
    original = type(model).generate

    def spying(self, texts, generator=None, progress=False, return_tokens=False):
        calls.append(list(texts))
        return original(self, texts, generator=generator, progress=progress,
                        return_tokens=return_tokens)
    monkeypatch.setattr(type(model), 'generate', spying)
    results, errors = {}, []

    def fire(name, text, duration):
        try:
            results[name] = service.generate({'text': text, 'duration': duration, 'seed': 3,
                                              'topk': 1, 'model': debug})
        except Exception as exc:   # reported below
            errors.append(exc)

    def run(jobs):
        threads = [threading.Thread(target=fire, args=job) for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
        assert not errors, errors

    try:
        run([(f'r{i}', f'tune {i}', 0.5) for i in range(3)])
        assert len(calls) == 1 and len(calls[0]) == 4 and calls[0][3] == calls[0][0]
        assert sorted(calls[0][:3]) == ['tune 0', 'tune 1', 'tune 2']
        alone = port_service(default_model=debug, cache_dir=cache)
        for name, res in results.items():
            assert res['metadata']['batch_size'] == 3 and np.isfinite(res['wav']).all()
            assert res['wav'].shape == (1, 12 * HOP)   # 0.5 s: 12 frames
        # greedy rows do not depend on their batch
        i = results['r1']['metadata']['batch_index']
        single = alone.generate({'text': calls[0][i], 'duration': 0.5, 'seed': 3, 'topk': 1,
                                 'model': debug})
        np.testing.assert_allclose(results['r1']['wav'], single['wav'], rtol=1e-5, atol=1e-5)

        calls.clear()
        run([('a', 'one', 0.5), ('b', 'two', 0.25)])
        assert len(calls) == 2 and sorted(len(c) for c in calls) == [1, 1]
        with pytest.raises(ValueError):
            service.generate({'text': '', 'duration': 0.5})
    finally:
        service.close()
    assert not service.batcher.worker.is_alive()


def test_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        serve.GenerationService()
    with pytest.raises(RuntimeError, match='CUDA'):
        serve.main(['--port', '0'])


def test_wav_bytes_match_jax():
    wav = tones(0.25, SR, seed=5)
    assert serve._wav_bytes(wav, SR) == jax_serve._wav_bytes(wav, SR)
    decoded, rate = serve._decode_wav_b64(wav_b64(wav))
    assert rate == SR and np.abs(decoded - wav).max() <= 1 / 32767
