"""REST generation server (counterpart of ``audiocraft_tpu/apps/serve.py``):
the headless counterpart of the fork's Gradio ``predict`` /
``predict_simple`` API (the reference's ``app.py``:244-675), stdlib-only.

    python -m audiocraft_tpu_torch.apps.serve [--port 8000] [--model debug]
        [--cache-dir DIR] [--device cuda] [--quantize [int8|int4]] [--kv-int8]
        [--batch-window MS] [--max-batch 8]

GET  /health    -> {"status": "ok", "model": "<name>"}
GET  /models    -> {"models": [...], "current": "<name>"}
POST /generate  -> audio/wav bytes, a compressed file, an MP4, or a
                   history-JSON document

POST body (all optional except "text"):
    {"text": "...", "model": "debug", "duration": 5, "seed": -1,
     "topk": 250, "topp": 0.0, "temperature": 1.0, "cfg_coef": 3.0,
     "melody_wav": "<base64 WAV>",     # melody conditioning
     "prompt_wav": "<base64 WAV>",     # continuation from this audio
     "title": "...",                    # embedded in history metadata
     "return_format": "wav",            # or mp3, ogg, flac, m4a, opus
     "return_video": false,             # an MP4 with the waveform
     "return_history_json": false}

Mirrors the reference ``predict_simple`` parameter surface
(``app.py``:593-675): model choice, sampling params, seed (-1 = random),
melody/continuation, and the ``return_history_json`` response mode
({audio_b64, seed, metadata}).

The models run on ``--device`` (default: the CUDA card, raising without
one; ``--device cpu`` runs the plain versions).  One generation runs at a
time, under :attr:`GenerationService.lock`: on the card the decode captures
CUDA graphs on whichever thread holds it (the batcher's worker, or an HTTP
handler thread without a batcher), and a capture fails if another thread
works on the card meanwhile.  So everything outside the lock stays on the
host: parsing a request, decoding its WAVs, encoding the response (the
generated audio comes to the host once per batch, inside the lock), and
``/health`` and ``/models``.
"""

from __future__ import annotations

import argparse
import base64
import json
import queue
import struct
import tempfile
import threading
import time
import typing as tp
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


def _wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """[C, T] float audio on the host -> a 16-bit PCM WAV file's bytes."""
    from ..io.audio_utils import i16_pcm
    data = i16_pcm(np.asarray(wav)).T.reshape(-1).astype('<i2').tobytes()
    C = wav.shape[0]
    block_align = C * 2
    header = b'RIFF' + struct.pack('<I', 36 + len(data)) + b'WAVE'
    header += b'fmt ' + struct.pack('<IHHIIHH', 16, 1, C, sample_rate,
                                    sample_rate * block_align, block_align, 16)
    header += b'data' + struct.pack('<I', len(data))
    return header + data


def _decode_wav_b64(b64: str) -> tp.Tuple[np.ndarray, int]:
    """base64 WAV -> (np.ndarray [C, T] float32, sample_rate), on the host."""
    from ..io.wav import wav_read
    raw = base64.b64decode(b64)
    with tempfile.NamedTemporaryFile(suffix='.wav') as tmp:
        tmp.write(raw)
        tmp.flush()
        return wav_read(tmp.name)


class _Slot:
    """One submitted request awaiting its batched result."""

    def __init__(self, req: dict, group: tp.Any):
        self.req = req
        self.group = group
        self.event = threading.Event()
        self.result: tp.Optional[dict] = None
        self.error: tp.Optional[Exception] = None


_STOP = object()   # the batcher's queue item that ends its worker


class _Batcher:
    """Continuous batching: coalesce concurrent compatible requests into one
    batched facade ``generate`` call.

    A decode step reads every weight once whatever the batch, so a serving
    window of a few tens of ms multiplies throughput under concurrency
    without hurting the empty-queue latency by more than the window.
    Requests are compatible when their (model, duration, sampling params)
    match, the per-call facade state; melody and continuation requests run
    as singleton batches through the same worker, which keeps one
    generation in flight on the device.
    """

    def __init__(self, service: 'GenerationService', window_s: float,
                 max_batch: int):
        self.service = service
        self.window_s = window_s
        self.max_batch = max_batch
        self.queue: 'queue.Queue[tp.Any]' = queue.Queue()
        self._carry: tp.Any = None
        self.worker = threading.Thread(target=self._run, daemon=True)
        self.worker.start()

    def submit(self, req: dict, group: tp.Any) -> dict:
        slot = _Slot(req, group)
        self.queue.put(slot)
        slot.event.wait()
        if slot.error is not None:
            raise slot.error
        assert slot.result is not None
        return slot.result

    def close(self, timeout: float = 60.0) -> None:
        """End the worker after the batches queued before this call; raises
        if it has not ended within ``timeout`` seconds."""
        self.queue.put(_STOP)
        self.worker.join(timeout)
        if self.worker.is_alive():
            raise RuntimeError(f"the batcher's worker did not end within {timeout} s")

    def _collect(self) -> tp.List[_Slot]:
        """The next batch; empty when the worker is to stop."""
        first = self._carry or self.queue.get()
        self._carry = None
        if first is _STOP:
            return []
        batch = [first]
        # singleton groups (melody/continuation) never coalesce
        if first.group is None:
            return batch
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is not _STOP and nxt.group == first.group:
                batch.append(nxt)
            else:
                # incompatible (or the stop): the seed of the next batch
                self._carry = nxt
                break
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                return
            try:
                results = self.service.generate_batch([s.req for s in batch])
                for slot, res in zip(batch, results):
                    slot.result = res
            except Exception as exc:  # surface to every waiter
                for slot in batch:
                    slot.error = exc
            finally:
                for slot in batch:
                    slot.event.set()


class GenerationService:
    """Model cache + request execution, separately testable from HTTP.

    ``device`` None is the CUDA card (raising without one); 'cpu' runs the
    plain versions."""

    def __init__(self, default_model: str = 'debug',
                 cache_dir: tp.Optional[str] = None,
                 quantize: tp.Union[bool, str] = False,
                 batch_window_ms: float = 0.0, max_batch: int = 8,
                 kv_dtype: tp.Optional[str] = None,
                 device: tp.Union[str, torch.device, None] = None):
        from ..builders import resolve_device
        self.default_model = default_model
        self.cache_dir = cache_dir
        self.device = resolve_device(device)
        # False | 'int8' | 'int4' (True kept as an alias for 'int8')
        self.quantize = 'int8' if quantize is True else quantize
        # 'int8' stores decode KV caches quantized; None = caches in the
        # decode's compute dtype
        self.kv_dtype = kv_dtype
        self.lock = threading.Lock()
        self.current_name = default_model
        self.batcher = (_Batcher(self, batch_window_ms / 1e3, max_batch)
                        if batch_window_ms > 0 else None)

    def close(self) -> None:
        """Stop the batcher's worker, if there is one."""
        if self.batcher is not None:
            self.batcher.close()

    def models(self) -> tp.List[str]:
        from ..ckpt.loaders import list_local_models
        return list_local_models(self.cache_dir)

    @staticmethod
    def _lm_is_quantized(model) -> bool:
        """True if any LM weight is already quantized.  Inspecting the model
        (not a name set) stays correct when the loader's cache evicts and
        rebuilds a model."""
        from ..nn.transformer import QuantizedWeight
        return any(isinstance(m, QuantizedWeight) for m in model.lm.modules())

    def _get_model(self, name: tp.Optional[str]):
        """The facade of ``name`` from the loader's cache, quantized and its
        KV dtype set as this service asks.  Nothing needs dropping after
        either: the facade keys its decode states (and CUDA graphs) by
        signature, the weights' addresses and dtypes and the KV dtype and
        buckets included, and its bf16 cast copy by the weights'
        structure."""
        from ..ckpt.loaders import load_model
        name = name or self.current_name
        model = load_model(name, self.cache_dir, self.device)
        if self.quantize and not self._lm_is_quantized(model):
            model.quantize_lm_weights(mode=self.quantize)
        if self.kv_dtype and model.kv_dtype != self.kv_dtype:
            model.kv_dtype = self.kv_dtype
            # bucketed KV growth rides along with the quantized-cache
            # serving recipe (see MusicGen.optimize_for_serving)
            model.kv_buckets = 'auto'
        self.current_name = name
        return model

    @staticmethod
    def _parse(req: dict) -> dict:
        """Validate a request; returns the parsed fields.  Raises ValueError
        on bad input.  Host only."""
        text = req.get('text', '')
        if not text:
            raise ValueError('missing "text"')
        duration = float(req.get('duration', 5.0))
        if not 0 < duration <= 720:
            raise ValueError('duration must be in (0, 720]')
        seed = int(req.get('seed', -1))
        if seed < 0:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        return {
            'text': text, 'duration': duration, 'seed': seed,
            'topk': int(req.get('topk', req.get('top_k', 250))),
            'topp': float(req.get('topp', req.get('top_p', 0.0))),
            'temperature': float(req.get('temperature', 1.0)),
            'cfg_coef': float(req.get('cfg_coef', 3.0)),
            'melody': req.get('melody_wav'),
            'prompt': req.get('prompt_wav'),
            'title': req.get('title', ''),
            'model': req.get('model'),
        }

    @staticmethod
    def _group_key(p: dict) -> tp.Optional[tuple]:
        """Batching compatibility key; None = must run alone."""
        if p['melody'] is not None or p['prompt'] is not None:
            return None
        return (p['model'], p['duration'], p['topk'], p['topp'],
                p['temperature'], p['cfg_coef'])

    def generate(self, req: dict) -> dict:
        """Request dict -> {"wav": np[C, T] float32, "sample_rate", "seed",
        "metadata"}.  Raises ValueError on bad input.

        With ``batch_window_ms > 0``, concurrent compatible requests
        coalesce into one batched facade call (continuous batching)."""
        if self.batcher is not None:
            parsed = self._parse(req)     # validate on the caller thread
            return self.batcher.submit(req, self._group_key(parsed))
        return self.generate_batch([req])[0]

    def generate_batch(self, reqs: tp.List[dict]) -> tp.List[dict]:
        """Run a list of compatible requests as ONE facade generate call.
        The sampling generator is seeded from the first request's seed; each
        response's metadata records the shared seed and, when batched, its
        batch index and the batch size.

        The batch is padded to the next power-of-two bucket (repeating the
        first prompt).  Coalesced batches arrive at any size, and each batch
        size is its own decode signature: its own decode state with KV
        caches at full capacity and its own CUDA graphs, captured on first
        use.  With the default ``max_batch`` of 8 the buckets are 1, 2, 4
        and 8, exactly the four states the facade's ``DecodeCache`` keeps
        (``max_states``), so steady traffic of one duration never captures
        again, where unpadded sizes would evict and recapture."""
        ps = [self._parse(r) for r in reqs]
        lead = ps[0]
        texts = [p['text'] for p in ps]
        n_real = len(texts)
        bucket = 1
        while bucket < n_real:
            bucket *= 2
        texts = texts + [texts[0]] * (bucket - n_real)
        with self.lock:  # one generation at a time per device
            model = self._get_model(lead['model'])
            model.set_generation_params(
                duration=lead['duration'], top_k=lead['topk'],
                top_p=lead['topp'], temperature=lead['temperature'],
                cfg_coef=lead['cfg_coef'],
                extend_stride=min(10.0, model.max_duration / 2))
            generator = torch.Generator().manual_seed(lead['seed'])
            if lead['prompt'] is not None:
                if len(ps) != 1:
                    raise ValueError('a continuation request runs alone')
                p_wav, p_sr = _decode_wav_b64(lead['prompt'])
                m_wavs, m_sr = None, None
                if lead['melody'] is not None:
                    m_wav, m_sr = _decode_wav_b64(lead['melody'])
                    m_wavs = [m_wav]
                wavs = model.generate_continuation(
                    p_wav[None], p_sr, texts, melody_wavs=m_wavs,
                    melody_sample_rate=m_sr, generator=generator)
            elif lead['melody'] is not None:
                if len(ps) != 1:
                    raise ValueError('a melody request runs alone')
                m_wav, m_sr = _decode_wav_b64(lead['melody'])
                wavs = model.generate_with_chroma(texts, [m_wav], m_sr,
                                                  generator=generator)
            else:
                wavs = model.generate(texts, generator=generator)
            # to the host once per batch, before another thread may capture
            wavs = wavs[:n_real].float().cpu().numpy()
            sample_rate = model.sample_rate
            name = model.name

        out = []
        for i, p in enumerate(ps):
            metadata = {
                'prompt': p['text'], 'model': name, 'Seed': lead['seed'],
                'duration': p['duration'], 'topk': p['topk'],
                'topp': p['topp'], 'temperature': p['temperature'],
                'cfg_coef': p['cfg_coef'], 'title': p['title'],
                'melody_condition': p['melody'] is not None,
                'continuation': p['prompt'] is not None,
            }
            if len(ps) > 1:
                metadata['batch_index'] = i
                metadata['batch_size'] = len(ps)
            out.append({'wav': wavs[i], 'sample_rate': sample_rate,
                        'seed': lead['seed'], 'metadata': metadata})
        return out


def make_handler(service: GenerationService):
    """The request handler class of a ``ThreadingHTTPServer`` over
    ``service``; builds or loads the hand kernels first."""
    from ..utils.misc import enable_compilation_cache
    enable_compilation_cache(service.device)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/health':
                self._json(200, {'status': 'ok',
                                 'model': service.current_name})
            elif self.path == '/models':
                self._json(200, {'models': service.models(),
                                 'current': service.current_name})
            else:
                self._json(404, {'error': 'not found'})

        def do_POST(self):
            if self.path != '/generate':
                self._json(404, {'error': 'not found'})
                return
            try:
                length = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(length) or b'{}')
                result = service.generate(req)
            except (ValueError, json.JSONDecodeError) as exc:
                self._json(400, {'error': str(exc)})
                return
            except FileNotFoundError as exc:
                self._json(404, {'error': str(exc)})
                return
            fmt = str(req.get('return_format', 'wav')).lower()
            if fmt == 'wav':
                body = _wav_bytes(result['wav'], result['sample_rate'])
                mime = 'audio/wav'
            else:
                # compressed response via the native libavcodec encoder
                # (reference audio_write mp3/ogg/flac, audio.py:164-228)
                try:
                    from ..io.native import MIME_TYPES, encode_audio
                    with tempfile.NamedTemporaryFile(
                            suffix=f'.{fmt}') as tmp:
                        encode_audio(tmp.name, result['wav'],
                                     result['sample_rate'], format=fmt)
                        body = open(tmp.name, 'rb').read()
                except ValueError as exc:
                    # unknown format OR codec/sample-rate mismatch (e.g.
                    # opus at 32 kHz): client error, not a server fault
                    self._json(400, {'error': str(exc)})
                    return
                except Exception as exc:
                    self._json(500, {'error': f'encode failed: {exc}'})
                    return
                mime = MIME_TYPES.get(fmt, 'application/octet-stream')
            if req.get('return_video'):
                # animated-waveform MP4 with embedded metadata (reference
                # make_waveform + mutagen path, modules/gradio.py:35-273)
                try:
                    from ..io.titlecard import settings_text
                    from ..io.video import make_waveform_video
                    with tempfile.NamedTemporaryFile(suffix='.mp4') as tmp:
                        make_waveform_video(
                            tmp.name, result['wav'], result['sample_rate'],
                            metadata={'title': req.get('title', ''),
                                      'comment': settings_text(
                                          result['metadata'])},
                            title=req.get('title', ''),
                            settings=settings_text(result['metadata']),
                            background=req.get('background'))
                        video = open(tmp.name, 'rb').read()
                except Exception as exc:
                    self._json(500, {'error': f'video mux failed: {exc}'})
                    return
                self.send_response(200)
                self.send_header('Content-Type', 'video/mp4')
                self.send_header('X-Seed', str(result['seed']))
                self.send_header('Content-Length', str(len(video)))
                self.end_headers()
                self.wfile.write(video)
                return
            if req.get('return_history_json'):
                self._json(200, {
                    'audio_b64': base64.b64encode(body).decode(),
                    'seed': result['seed'],
                    'metadata': result['metadata'],
                })
                return
            self.send_response(200)
            self.send_header('Content-Type', mime)
            self.send_header('X-Seed', str(result['seed']))
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--port', type=int, default=8000)
    parser.add_argument('--host', default='127.0.0.1')
    parser.add_argument('--model', default='debug')
    parser.add_argument('--cache-dir', default=None)
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card); 'cpu' runs the plain "
                             "versions")
    parser.add_argument('--quantize', nargs='?', const='int8', default=False,
                        choices=['int8', 'int4'],
                        help='weight-only quantized LM decode (bare flag means int8)')
    parser.add_argument('--batch-window', type=float, default=0.0,
                        metavar='MS',
                        help='continuous batching: coalesce concurrent '
                             'compatible requests for up to MS milliseconds '
                             'into one batched generate (0 = off)')
    parser.add_argument('--max-batch', type=int, default=8,
                        help='max requests per coalesced batch')
    parser.add_argument('--kv-int8', action='store_true',
                        help='int8 KV-cache decode')
    args = parser.parse_args(argv)

    service = GenerationService(args.model, args.cache_dir,
                                quantize=args.quantize,
                                batch_window_ms=args.batch_window,
                                max_batch=args.max_batch,
                                kv_dtype='int8' if args.kv_int8 else None,
                                device=args.device)
    with service.lock:
        service._get_model(args.model)  # fail fast + warm the cache
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service))
    print(f"serving on http://{args.host}:{args.port} "
          f"(model: {service.current_name}, device: {service.device})")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.close()


if __name__ == '__main__':
    main()
