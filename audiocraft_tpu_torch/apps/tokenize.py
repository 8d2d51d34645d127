"""CLI: batch audio tokenization, the production EnCodec pipeline
(counterpart of ``audiocraft_tpu/apps/tokenize.py``).

    python -m audiocraft_tpu_torch.apps.tokenize IN.wav [IN2.mp3 ...] \\
        --out tokens.npz [--checkpoint CKPT_DIR] [--n-q 4] \\
        [--batch-seconds 10] [--batch-rows 32] [--stats] [--device cpu]

The batched pipeline cuts every input into chunks of ``--batch-seconds`` and
encodes fixed ``[batch-rows, 1, batch-seconds * sr]`` batches.  One host
thread decodes, resamples and downmixes batch i+1 on the CPU (the native
library's GIL-free batch decoder where it loads and an input is not WAV,
else the numpy WAV reader) while the card encodes batch i; the rows go into
pinned host memory and to the card with ``non_blocking=True``.  The encode
is the codec's own ``encode`` on its default route: on the card the fused
route (the input conv through K5, two stages through K4), the LSTM through
K2 and the RVQ through K1.  The npz holds ``codes`` [chunks, K, frames]
int32 and ``meta``, the rows' paths and start times as JSON bytes.

Whole-file modes write one ``codes_<i>`` entry per input:
``--chunk`` tokenizes each file as one sequence in shifted windows
(``codec/chunked.chunked_encode``, token-exact, about one window's peak
memory); ``--pod`` time-shards each file over a ``torch.distributed`` group
(``dist/pod.pod_encode``): one process is one shard, and under ``torchrun``
every rank joins the data group (NCCL on the card, gloo on the CPU), holds
the whole file, encodes its shard, and rank 0 writes the npz.

``--checkpoint`` is a checkpoint directory in either layout
(``ckpt/io.load_checkpoint``); without one the 32 kHz codec has random
weights from seed 0 and codebooks of zeros (a throughput measurement).
``--stats`` prints the ``Meter`` line and the host's decode time a batch.
``--device`` defaults to the CUDA card and raises without one; ``--device
cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import typing as tp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

Chunk = tp.Tuple[str, float, dict]


def plan_chunks(paths: tp.Sequence[str], seconds: float,
                infos: tp.Sequence[tp.Tuple[int, float, int]]) -> tp.List[Chunk]:
    """(path, seek time, row meta) of every chunk of ``seconds`` of every
    input, ``infos`` being each input's (sample_rate, duration, channels)."""
    chunks = []
    for path, (_sr, dur, _ch) in zip(paths, infos):
        for i in range(max(int(np.ceil(dur / seconds)), 1)):
            chunks.append((str(path), i * seconds, {'path': str(path), 'start': i * seconds}))
    return chunks


def load_rows(batch: tp.Sequence[Chunk], n_rows: int, seconds: float, sample_rate: int,
              use_native: bool, threads: int = 8, pin: bool = False) -> torch.Tensor:
    """Decode one batch's chunks, resampled to ``sample_rate`` and downmixed
    on the CPU: [n_rows, 1, seconds * sample_rate] fp32 (in pinned memory
    with ``pin``), rows past the chunks and samples past a file's end zero."""
    from ..io import native
    from ..io.audio_utils import convert_audio
    from ..io.wav import audio_read

    seg = int(seconds * sample_rate)
    paths, seeks = [c[0] for c in batch], [c[1] for c in batch]
    durs = [seconds] * len(batch)
    if use_native:
        decoded = native.decode_audio_batch(paths, seeks, durs, num_threads=threads)
    else:
        decoded = [audio_read(p, s, d) for p, s, d in zip(paths, seeks, durs)]
    rows = torch.zeros((n_rows, 1, seg), pin_memory=pin)
    for i, (wav, sr) in enumerate(decoded):
        mono = convert_audio(torch.from_numpy(wav), sr, sample_rate, 1)
        t = min(mono.shape[-1], seg)
        rows[i, :, :t] = mono[..., :t]
    return rows


def encode_batches(model, batches: tp.Sequence[tp.Sequence[Chunk]],
                   load: tp.Callable[[tp.Sequence[Chunk]], torch.Tensor],
                   device: torch.device) -> tp.Tuple[np.ndarray, dict]:
    """Encode each batch's rows on ``device`` while one host thread loads
    the next (``load``).  Returns the codes of the chunks [chunks, K, frames]
    and the pipeline's timings: its start on the host clock, its seconds,
    the host's seconds to load each batch and the seconds the device loop
    waited for the host."""
    def timed_load(batch):
        t = time.perf_counter()
        rows = load(batch)
        return rows, time.perf_counter() - t

    codes, load_s, wait_s = [], [], 0.0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as prefetch:
        future = prefetch.submit(timed_load, batches[0])
        for i in range(len(batches)):
            t = time.perf_counter()
            host, spent = future.result()
            wait_s += time.perf_counter() - t
            load_s.append(spent)
            if i + 1 < len(batches):
                future = prefetch.submit(timed_load, batches[i + 1])
            codes.append(model.encode(host.to(device, non_blocking=True))[0][:len(batches[i])])
    out = torch.cat(codes).cpu().numpy()
    return out, {'started': t0, 'seconds': time.perf_counter() - t0, 'load_s': load_s,
                 'wait_s': wait_s}


def _read_whole(path: str, sample_rate: int) -> torch.Tensor:
    """A whole file, resampled and downmixed on the CPU: [1, T]."""
    from ..io import native
    from ..io.audio_utils import convert_audio
    from ..io.wav import audio_info, audio_read

    _sr, dur, _ch = audio_info(path)
    if native.available() and not str(path).endswith('.wav'):
        (wav, sr), = native.decode_audio_batch([str(path)], [0.0], [dur])
    else:
        wav, sr = audio_read(path, 0.0, dur)
    return convert_audio(torch.from_numpy(wav), sr, sample_rate, 1)


def _tokenize_wholefile(args, model, device, encode_fn, label: str, extra: str = '',
                        write: bool = True) -> dict:
    """One ``codes_<i>`` entry per input, each file encoded as one sequence."""
    hop = model.encoder.hop_length
    out, meta, total_sec = {}, [], 0.0
    t0 = time.perf_counter()
    for i, path in enumerate(args.inputs):
        mono = _read_whole(path, model.sample_rate)
        frames = -(-mono.shape[-1] // hop)
        codes = encode_fn(mono[None].to(device))
        out[f'codes_{i}'] = codes[0, :, :frames].cpu().numpy()
        meta.append({'path': str(path), 'frames': frames})
        total_sec += mono.shape[-1] / model.sample_rate
    dt = time.perf_counter() - t0
    if write:
        if args.stats:
            print(f"{label} tokenize: {len(args.inputs)} file(s), {total_sec:.1f} audio-sec"
                  f"{extra} in {dt:.2f} s", file=sys.stderr)
        np.savez(args.out, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8), **out)
        print(f"wrote {[v.shape for v in out.values()]} tokens to {args.out}")
    return {'codes': out, 'seconds': dt, 'audio_seconds': total_sec}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('inputs', nargs='+', help='audio files (wav/mp3/...)')
    parser.add_argument('--out', default='tokens.npz')
    parser.add_argument('--checkpoint', default=None)
    parser.add_argument('--n-q', type=int, default=None)
    parser.add_argument('--batch-seconds', type=float, default=10.0)
    parser.add_argument('--batch-rows', type=int, default=32)
    parser.add_argument('--decode-threads', type=int, default=8)
    parser.add_argument('--stats', action='store_true')
    parser.add_argument('--pod', action='store_true',
                        help='time-shard each whole file over the torch.distributed group '
                             '(dist/pod.pod_encode); one codes_<i> entry per input')
    parser.add_argument('--chunk', action='store_true',
                        help='tokenize each whole file in sequential shifted windows '
                             '(codec/chunked), token-exact at about one window\'s peak memory')
    parser.add_argument('--chunk-frames', type=int, default=1500,
                        help='window length in frames for --chunk')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card); 'cpu' runs the plain "
                             "versions of the kernels")
    args = parser.parse_args(argv)

    from ..builders import get_encodec_32khz, resolve_device
    from ..ckpt.io import load_checkpoint
    from ..dist.mesh import in_torchrun, make_data_group, rank, world_size
    from ..io import native
    from ..io.wav import audio_info
    from ..obs import Meter
    from ..utils.misc import enable_compilation_cache

    device = resolve_device(args.device)
    group = None
    if args.pod and in_torchrun():
        if device.type == 'cuda':
            device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
            torch.cuda.set_device(device)
        group = make_data_group('nccl' if device.type == 'cuda' else 'gloo')
    enable_compilation_cache(device)
    if args.checkpoint:
        model = load_checkpoint(args.checkpoint, device)[0]
    else:
        model = get_encodec_32khz(device=device, seed=0)
    if args.n_q:
        model.set_num_codebooks(args.n_q)

    if args.pod:
        from ..dist.pod import pod_encode
        return _tokenize_wholefile(args, model, device, lambda x: pod_encode(model, x, group),
                                   'pod', extra=f" over {world_size(group)} device(s)",
                                   write=rank(group) == 0)
    if args.chunk:
        from ..codec.chunked import chunked_encode
        return _tokenize_wholefile(
            args, model, device,
            lambda x: chunked_encode(model, x, chunk_frames=args.chunk_frames)[0], 'chunked')

    sr_model = model.sample_rate
    chunks = plan_chunks(args.inputs, args.batch_seconds, [audio_info(p) for p in args.inputs])
    use_native = native.available() and any(not str(p).endswith('.wav') for p in args.inputs)
    batches = [chunks[i:i + args.batch_rows] for i in range(0, len(chunks), args.batch_rows)]

    def load(batch):
        return load_rows(batch, args.batch_rows, args.batch_seconds, sr_model, use_native,
                         args.decode_threads, pin=device.type == 'cuda')

    codes, stats = encode_batches(model, batches, load, device)
    meter = Meter(started=stats['started'])
    meter.add(audio_seconds=len(chunks) * args.batch_seconds, tokens=int(codes.size),
              items=len(chunks))
    stats['rates'] = meter.rates()
    if args.stats:
        print(f"tokenize pipeline: {meter.report()}", file=sys.stderr)
        print(f"tokenize host: {len(batches)} batch(es) of {args.batch_rows} rows, load "
              f"{1e3 * np.mean(stats['load_s']):.1f} ms a batch (max "
              f"{1e3 * max(stats['load_s']):.1f}), the device loop waited "
              f"{1e3 * stats['wait_s']:.1f} ms for the host", file=sys.stderr)
    np.savez(args.out, codes=codes,
             meta=np.frombuffer(json.dumps([m for _, _, m in chunks]).encode(), np.uint8))
    print(f"wrote {codes.shape} tokens to {args.out}")
    return {'codes': codes, **stats}


if __name__ == '__main__':
    main()
