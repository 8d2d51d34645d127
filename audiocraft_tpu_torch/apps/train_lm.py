"""CLI: MusicGen LM training over EnCodec tokens (counterpart of
``audiocraft_tpu/apps/train_lm.py``): delay-pattern masked cross-entropy
with classifier-free-guidance text dropout.

    python -m audiocraft_tpu_torch.apps.train_lm --debug --synthetic --steps 2 [--device cpu]

Each step encodes a batch of audio with the (frozen) codec on the device,
drops the text conditions with probability ``--cfg-dropout``, embeds them,
and takes one optimizer step of the LM; a weight EMA follows when
``--ema-decay`` is set.  It logs ``step N  ce X (Ys)``.  ``--device``
defaults to the CUDA card and raises without one; ``--device cpu`` runs the
kernels' plain versions.

The codec is the random debug codec, as in the JAX package, or the codec
checkpoint directory ``--codec-ckpt`` (``ckpt/io.py``).  ``--synthetic``
(the default when no DATA_DIR is given) trains on seeded noise, each step's
batch and condition dropout seeded by the step.  Without ``--debug`` the LM
is MusicGen-small with T5-base text conditioning, whose tokenizer vocabulary
is not in the repository, so its tokenize step raises.  DATA_DIR (a
directory of audio files or a jsonl manifest) is read through
``data/audio_dataset.AudioDataset`` with ``--steps`` x ``--batch`` segments of
``--segment`` s at the codec's rate, epoch 0, step N training on the N-th
batch (so a resumed run too), with empty descriptions, as in the JAX package.

``--ckpt DIR`` exports the LM and its conditioners at the end as a
checkpoint directory (the weight EMA with ``--ema-decay``), which
``ckpt/loaders.get_pretrained`` serves beside a ``compression/`` codec
directory.  ``--save-every N`` also writes the whole run (weights,
optimizer moments, EMA, step) to ``DIR`` every N steps and at the end
(``ckpt/train_state.py``); ``--resume`` continues from it and trains on the
batches the whole run would have.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('data', nargs='?', default=None)
    parser.add_argument('--steps', type=int, default=50)
    parser.add_argument('--batch', type=int, default=4)
    parser.add_argument('--segment', type=float, default=2.0)
    parser.add_argument('--lr', type=float, default=1e-4)
    parser.add_argument('--lr-schedule', default=None,
                        choices=['cosine', 'inverse_sqrt', 'polynomial', 'linear_warmup'],
                        help='LR schedule (default: constant --lr); MusicGen trains with '
                             'cosine + warmup')
    parser.add_argument('--warmup', type=int, default=0)
    parser.add_argument('--weight-decay', type=float, default=0.1)
    parser.add_argument('--max-grad-norm', type=float, default=None)
    parser.add_argument('--ema-decay', type=float, default=0.0,
                        help='>0: keep a weight EMA')
    parser.add_argument('--cfg-dropout', type=float, default=0.1)
    parser.add_argument('--ckpt', default=None)
    parser.add_argument('--save-every', type=int, default=0)
    parser.add_argument('--resume', action='store_true')
    parser.add_argument('--codec-ckpt', default=None)
    parser.add_argument('--debug', action='store_true', help='debug-size LM')
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--grad-accum', type=int, default=1,
                        help='sequential microbatches per optimizer step (--batch must be '
                             'divisible by it)')
    parser.add_argument('--compute-dtype', default=None, choices=['bfloat16'],
                        help='mixed precision: bf16 forward and backward, fp32 master '
                             'parameters and optimizer state')
    parser.add_argument('--device', default=None,
                        help="torch device (default: the CUDA card); 'cpu' runs the plain "
                             "versions of the kernels")
    args = parser.parse_args(argv)
    if (args.save_every or args.resume) and not args.ckpt:
        parser.error('--save-every/--resume require --ckpt')

    import numpy as np
    import torch

    from ..builders import (get_debug_compression_model, get_debug_musicgen_lm, get_musicgen_lm,
                            resolve_device)
    from ..ckpt.io import load_checkpoint, save_checkpoint
    from ..ckpt.train_state import has_train_state, load_train_state, save_train_state
    from ..cond.attributes import ClassifierFreeGuidanceDropout, ConditioningAttributes
    from ..data.audio_dataset import AudioDataset
    from ..dist.train import make_lm_train_step
    from ..optim import ema_update, get_lr_schedule, make_optimizer
    from ..utils.misc import enable_compilation_cache

    device = resolve_device(args.device)
    enable_compilation_cache(device)
    if args.codec_ckpt:
        codec = load_checkpoint(args.codec_ckpt, device)[0]
    else:
        codec = get_debug_compression_model(32000, device=device, seed=0)
    if args.debug:
        lm, provider = get_debug_musicgen_lm(device=device, seed=1)
    else:
        lm, provider = get_musicgen_lm('small', n_q=codec.num_codebooks, device=device, seed=1)
    lr = get_lr_schedule(args.lr_schedule, args.lr, warmup_steps=args.warmup,
                         total_steps=args.steps)
    optimizer = make_optimizer('adamw', lr, betas=(0.9, 0.95), weight_decay=args.weight_decay,
                               max_grad_norm=args.max_grad_norm)
    step_fn = make_lm_train_step(lm, optimizer, compute_dtype=args.compute_dtype,
                                 grad_accum=args.grad_accum)
    params = list(lm.parameters())
    opt_state = optimizer.init(params)
    wema = [p.detach().clone() for p in params] if args.ema_decay > 0 else []
    run = {'model': lm.state_dict(), 'opt': opt_state, 'wema': wema}

    start_step = 0
    if args.resume and has_train_state(args.ckpt):
        start_step, _ = load_train_state(args.ckpt, run)
        print(f"resumed at step {start_step}", flush=True)
    seg = int(args.segment * codec.sample_rate)
    ds = None
    if args.data and not args.synthetic:
        ds = AudioDataset.from_path(args.data, segment_duration=args.segment,
                                    sample_rate=codec.sample_rate, channels=1,
                                    num_samples=args.steps * args.batch)
        ds.start_epoch(0)
        shards = list(ds.shard_indices(args.batch, 0, 1))
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        # chosen by the step, so a resumed run sees the batches it would have
        if ds is None:
            wav = (np.random.RandomState(step).randn(args.batch, 1, seg) * 0.1
                   ).astype(np.float32)
            text = 'synthetic'
        else:
            wav, text = ds.collater([ds[i] for i in shards[step % len(shards)]]), ''
        attrs = ClassifierFreeGuidanceDropout(p=args.cfg_dropout, seed=step)(
            [ConditioningAttributes(text={'description': text}) for _ in range(args.batch)])
        with torch.no_grad():
            cond_tensors = provider(provider.tokenize(attrs))
        codes = codec.encode(torch.from_numpy(wav).to(device))[0]
        metrics = step_fn(opt_state, codes, cond_tensors)
        if wema:
            ema_update(wema, params, args.ema_decay)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  ce {float(metrics['loss']):.4f}  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if args.save_every and (step + 1) % args.save_every == 0:
            save_train_state(args.ckpt, run, step + 1)

    if args.ckpt:
        if args.save_every:
            save_train_state(args.ckpt, run, args.steps)
        if wema:
            with torch.no_grad():
                for p, w in zip(params, wema):
                    p.copy_(w)
        save_checkpoint(args.ckpt, {'lm': lm, 'condition_provider': provider},
                        extra={'steps': args.steps, 'weights': 'ema' if wema else 'raw'})
        print(f"saved checkpoint to {args.ckpt}")

if __name__ == '__main__':
    main()
