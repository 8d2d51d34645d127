"""Batched generation pipeline (counterpart of
``audiocraft_tpu/apps/batch_generate.py``; the fork's batched demo,
``app_batched.py``): many prompts per device pass, optional per-prompt
melody wavs, waveform videos rendered in a process pool so the card never
waits on media encoding.

    python -m audiocraft_tpu_torch.apps.batch_generate prompts.txt --out outdir \
        [--model debug] [--duration 12] [--batch-size 8] [--video] [--device cuda]

`prompts.txt`: one prompt per line; optionally "prompt<TAB>melody.wav".
The model runs on ``--device`` (default: the CUDA card, raising without
one; ``--device cpu`` runs the plain versions).  The video workers are
started with the ``spawn`` method and run on the host only: they never
touch the card, and no CUDA state is inherited from this process.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import time
import typing as tp
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch


def _render_video(args: tp.Tuple[str, str, int, dict]) -> str:
    """Worker: wav file -> waveform mp4 (runs in a subprocess, on the host)."""
    wav_path, out_path, sample_rate, metadata = args
    from ..io.titlecard import settings_text
    from ..io.video import make_waveform_video
    from ..io.wav import wav_read
    wav, sr = wav_read(wav_path)
    make_waveform_video(out_path, wav, sr, metadata=metadata,
                        title=metadata.get('prompt', '')[:60],
                        settings=settings_text(metadata))
    return out_path


def read_prompts(path: tp.Union[str, Path]
                 ) -> tp.List[tp.Tuple[str, tp.Optional[str]]]:
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        if '\t' in line:
            text, melody = line.split('\t', 1)
            out.append((text[:512], melody or None))
        else:
            out.append((line[:512], None))
    return out


def generate_batches(model, prompts, duration: float, batch_size: int,
                     seed: int = 0):
    """Yield (index, text, wav np[C, T]) per prompt, batching device passes.

    Prompts with a melody run through generate_with_chroma; plain ones
    through generate, grouped so each device pass is one batch, the plain
    prompts first.  Each batch samples from its own generator, seeded with
    ``seed + lo`` (plain) or ``seed + 10_000 + lo`` (melody), ``lo`` the
    batch's first position in its group.  Each batch's audio comes to the
    host once.
    """
    from ..io.wav import wav_read

    model.set_generation_params(duration=duration)
    plain = [(i, t) for i, (t, m) in enumerate(prompts) if m is None]
    melody = [(i, t, m) for i, (t, m) in enumerate(prompts) if m is not None]

    for lo in range(0, len(plain), batch_size):
        chunk = plain[lo:lo + batch_size]
        wavs = model.generate([t for _, t in chunk],
                              generator=torch.Generator().manual_seed(seed + lo))
        for (i, t), w in zip(chunk, wavs.cpu().numpy()):
            yield i, t, w
    for lo in range(0, len(melody), batch_size):
        chunk = melody[lo:lo + batch_size]
        mels, srs = [], set()
        for _, _, m in chunk:
            w, sr = wav_read(m)
            mels.append(w)
            srs.add(sr)
        if len(srs) != 1:
            raise ValueError("melody wavs in one batch must share a rate")
        wavs = model.generate_with_chroma(
            [t for _, t, _ in chunk], mels, srs.pop(),
            generator=torch.Generator().manual_seed(seed + 10_000 + lo))
        for (i, t, _), w in zip(chunk, wavs.cpu().numpy()):
            yield i, t, w


def main(argv=None) -> tp.List[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('prompts')
    parser.add_argument('--out', required=True)
    parser.add_argument('--model', default='debug')
    parser.add_argument('--cache-dir', default=None)
    parser.add_argument('--duration', type=float, default=12.0)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--video', action='store_true',
                        help='render waveform MP4s in a process pool')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card); 'cpu' runs the plain "
                             "versions")
    args = parser.parse_args(argv)

    from ..builders import resolve_device
    from ..ckpt.loaders import load_model
    from ..io.wav import wav_write
    from ..utils.misc import enable_compilation_cache

    device = resolve_device(args.device)
    enable_compilation_cache(device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    prompts = read_prompts(args.prompts)
    model = load_model(args.model, args.cache_dir, device)

    manifest = []
    futures = []
    pool = (ProcessPoolExecutor(3, mp_context=multiprocessing.get_context('spawn'))
            if args.video else None)
    t0 = time.time()
    try:
        for i, text, wav in generate_batches(model, prompts, args.duration,
                                             args.batch_size, args.seed):
            wav_path = out_dir / f'{i:04d}.wav'
            wav_write(wav, wav_path, model.sample_rate)
            meta = {'prompt': text, 'model': model.name,
                    'duration': args.duration, 'index': i}
            manifest.append({**meta, 'wav': wav_path.name})
            if pool is not None:
                futures.append(pool.submit(
                    _render_video,
                    (str(wav_path), str(out_dir / f'{i:04d}.mp4'),
                     model.sample_rate, meta)))
        for f in futures:
            f.result()
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    (out_dir / 'manifest.json').write_text(json.dumps(manifest, indent=2))
    print(f"generated {len(manifest)} clips in {time.time() - t0:.1f}s "
          f"-> {out_dir}")
    return manifest


if __name__ == '__main__':
    main()
