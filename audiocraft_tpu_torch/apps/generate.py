"""CLI: text-to-music generation, the app.py predict flow headless
(counterpart of ``audiocraft_tpu/apps/generate.py``).

Usage:
    python -m audiocraft_tpu_torch.apps.generate "an upbeat techno track" \
        [--duration 10] [--out out.wav] [--checkpoint CKPT] [--seed 42] \
        [--melody melody.wav] [--overlap 2] [--segment-duration 30] \
        [--device cuda]

``--checkpoint`` accepts anything :func:`ckpt.loaders.get_pretrained`
resolves (reference musicgen.py:100-143 / app.py:300-315): a short name
('small', 'melody', ...), an imported checkpoint directory (the port's or
one the JAX package wrote), or a raw HF hub snapshot directory
(config.json + safetensors, converted once into the cache).
``--optimize`` applies the serving recipe (int8 weights + int8 KV).

Durations beyond the model's window use stride extension, or with a melody
the fork's segment-stitch extension with overlap crossfades
(``gen/extend.py``).  Without a checkpoint a debug-scale model generates
(noise-like) audio, which smoke-tests the whole pipeline.  The model runs
on ``--device`` (default: the CUDA card, raising without one; ``--device
cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('text')
    parser.add_argument('--duration', type=float, default=10.0)
    parser.add_argument('--out', default='out.wav')
    parser.add_argument('--checkpoint', default=None,
                        help="model name ('small', ...), imported checkpoint "
                             "dir, or HF snapshot dir; default: debug model")
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--melody', default=None, help='melody wav file')
    parser.add_argument('--overlap', type=int, default=2)
    parser.add_argument('--segment-duration', type=int, default=30)
    parser.add_argument('--top-k', type=int, default=250)
    parser.add_argument('--temperature', type=float, default=1.0)
    parser.add_argument('--cfg-coef', type=float, default=3.0)
    parser.add_argument('--optimize', action='store_true',
                        help='int8 weights + int8 KV serving recipe')
    parser.add_argument('--format', default='wav',
                        choices=('wav', 'mp3', 'ogg', 'flac'),
                        help='output audio format')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card); 'cpu' runs the plain "
                             "versions")
    args = parser.parse_args(argv)

    import torch

    from ..builders import resolve_device
    from ..gen.extend import generate_music_segments, stitch_segments
    from ..gen.musicgen import get_debug_melody_musicgen, get_debug_musicgen
    from ..io.wav import audio_read, audio_write
    from ..utils.misc import enable_compilation_cache

    device = resolve_device(args.device)
    enable_compilation_cache(device)

    melody = None
    if args.melody:
        wav, sr = audio_read(args.melody)
        melody = (sr, wav.mean(0))

    if args.checkpoint:
        from ..ckpt.loaders import load_model
        model = load_model(args.checkpoint, device=device)
        if args.optimize:
            model.optimize_for_serving()
        if melody is not None:
            names = list(model.condition_provider.conditioners)
            if 'self_wav' not in names:
                raise SystemExit(
                    f"--melody requires a melody-conditioned checkpoint (a "
                    f"'self_wav' chroma conditioner); {args.checkpoint!r} "
                    f"has conditioners {names}. Use a *-melody checkpoint "
                    f"or drop --melody.")
    elif melody is not None:
        model = get_debug_melody_musicgen(device=device, seed=args.seed)
    else:
        model = get_debug_musicgen(device=device, seed=args.seed)

    generator = torch.Generator().manual_seed(args.seed)
    model.set_generation_params(
        duration=min(args.duration, model.max_duration), top_k=args.top_k,
        temperature=args.temperature, cfg_coef=args.cfg_coef)

    if melody is not None and args.duration > args.segment_duration:
        segments, _ = generate_music_segments(
            args.text, melody, args.seed, model, duration=int(args.duration),
            overlap=args.overlap, segment_duration=args.segment_duration)
        wav = stitch_segments(segments, model.sample_rate, args.overlap)
    elif melody is not None:
        wav = model.generate_with_chroma([args.text], [melody[1][None]],
                                         melody[0], generator=generator)
    else:
        model.duration = args.duration  # stride extension handles > window
        wav = model.generate([args.text], generator=generator, progress=True)

    out = wav[0].cpu()
    stem = args.out
    for suffix in ('.wav', '.mp3', '.ogg', '.flac'):
        stem = stem.removesuffix(suffix)
    path = audio_write(stem, out, model.sample_rate,
                       format=args.format, strategy='loudness')
    print(f"wrote {out.shape[-1] / model.sample_rate:.1f}s of audio to {path}")
    return path


if __name__ == '__main__':
    main()
